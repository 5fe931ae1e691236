"""Everything a run feeds both sides, made from `--seed`: the autoencoder's
and the fusion projection's weights, fused windows, and robot sensor steps.

Each draw has its own stream, `stream(seed, tag)`, so adding a draw changes
no other.  Weights and windows are drawn on the run's device in a few
large calls (a `torch.Generator` there), in fp32, the type they are served
in; the sensor steps are numpy arrays, the host payloads a robot's
subscribers would hand over.  None of it comes from the program: the
program under test and the plain reference both receive these tensors.
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Optional

import numpy as np
import torch


def stream(seed: int, tag: str) -> int:
    """A 63-bit seed for the draw `tag` of run `seed`."""
    return (int(seed) * 1_000_003 + zlib.crc32(tag.encode())) % (1 << 63)


def generator(device: torch.device, seed: int, tag: str) -> torch.Generator:
    g = torch.Generator(device=torch.device(device).type)
    g.manual_seed(stream(seed, tag))
    return g


def hidden_sizes(start: int, end: int, n_hidden: int) -> List[int]:
    """The reference's linear interpolation of layer widths, truncated to
    int (its utils/common_utils.py:22-31)."""
    diff = (start - end) / (n_hidden + 1)
    return [int(start - diff * (i + 1)) for i in range(n_hidden)]


def module_widths(config: dict) -> Dict[str, List[int]]:
    """The encoder's and decoder's widths, input first: 1728 -> ... -> 100
    and back for `all_1728`."""
    d, btl, n = config["input_size"], config["btl_size"], config["n_layers"]
    return {"encoder": [d, *hidden_sizes(d, btl, n - 1), btl],
            "decoder": [btl, *hidden_sizes(btl, d, n - 1), d]}


def ae_weights(config: dict, seed: int, device, trained: bool
               ) -> List[dict]:
    """Every FC layer of the autoencoder, encoder first: {"module",
    "index", "w" (N, K), "b" (N,), "leaky", "bn"}.  W and b ~ U(+-1/sqrt(K))
    (torch's and the reference's init), all in one draw.  Every layer but a
    module's last has LeakyReLU(0.2) and BatchNorm; `bn` holds its weight,
    bias, running mean and running variance: 1, 0, 0, 1 as initialised
    (`trained` False), or drawn about those, as a trained model holds them
    (one more draw)."""
    dev = torch.device(device)
    layers = []
    for module, widths in module_widths(config).items():
        last = len(widths) - 2
        for i, (k, n) in enumerate(zip(widths[:-1], widths[1:])):
            layers.append({"module": module, "index": i, "k": k, "n": n,
                           "leaky": i < last, "has_bn": i < last})
    total = sum(l["n"] * (l["k"] + 1) for l in layers)
    u = torch.rand(total, generator=generator(dev, seed, "ae"), device=dev)
    u = u.mul_(2.0).sub_(1.0)
    n_bn = sum(l["n"] for l in layers if l["has_bn"])
    if trained:
        bn_draw = torch.rand(4, n_bn, generator=generator(dev, seed, "bn"),
                             device=dev)
    at = bn_at = 0
    out = []
    for l in layers:
        k, n = l["k"], l["n"]
        bound = 1.0 / k ** 0.5
        w = u[at:at + n * k].view(n, k).mul(bound)
        b = u[at + n * k:at + n * (k + 1)].mul(bound)
        at += n * (k + 1)
        bn = None
        if l["has_bn"]:
            if trained:
                r = bn_draw[:, bn_at:bn_at + n]
                bn = {"weight": 0.8 + 0.4 * r[0], "bias": 0.2 * r[1] - 0.1,
                      "mean": 0.1 * r[2] - 0.05, "var": 0.5 + r[3]}
            else:
                bn = {"weight": torch.ones(n, device=dev),
                      "bias": torch.zeros(n, device=dev),
                      "mean": torch.zeros(n, device=dev),
                      "var": torch.ones(n, device=dev)}
            bn_at += n
        out.append({"module": l["module"], "index": l["index"], "w": w,
                    "b": b, "leaky": l["leaky"], "bn": bn})
    return out


#: (name, out channels, in channels, kernel) of the fusion projection's
#: convs, the reference's fusion layer shapes
FUSION_SHAPES = (
    ("rgb1", 16, 3, (2, 2)), ("rgb2", 16, 16, (3, 3)),
    ("rgb3", 16, 16, (2, 2)),
    ("dep1", 8, 1, (2, 2)), ("dep2", 8, 8, (3, 3)), ("dep3", 8, 8, (2, 2)),
    ("lid1", 8, 1, (18,)), ("lid2", 16, 8, (2,)), ("lid3", 32, 16, (2,)),
    ("lid4", 16, 32, (3,)), ("lid5", 32, 16, (2,)),
)


def fusion_weights(seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """The fusion convs' weights and biases, U(+-1/sqrt(fan_in)) as torch's
    conv init, in one draw: {name: {"w", "b"}}."""
    dev = torch.device(device)
    sizes = [(o, c * int(np.prod(k))) for _, o, c, k in FUSION_SHAPES]
    total = sum(o * (f + 1) for o, f in sizes)
    u = torch.rand(total, generator=generator(dev, seed, "fusion"),
                   device=dev).mul_(2.0).sub_(1.0)
    out, at = {}, 0
    for (name, o, c, k), (_, fan) in zip(FUSION_SHAPES, sizes):
        bound = 1.0 / fan ** 0.5
        out[name] = {"w": u[at:at + o * fan].view(o, c, *k).mul(bound),
                     "b": u[at + o * fan:at + o * (fan + 1)].mul(bound)}
        at += o * (fan + 1)
    return out


#: The fused windows' distribution, one for every cell: ReLU features of a
#: rank-32 latent signal (scale 1) plus a per-column bias (0.1) and noise
#: (0.1); an anomalous window shifts its latent by 3.  No published source
#: gives one (the reference's windows are its robot's recordings), and no
#: timed kernel's work depends on it: it sets how well conditioned the NAP
#: fit is, so every correctness limit was read on it.
WINDOWS = {"latent_rank": 32, "signal_scale": 1.0, "bias_scale": 0.1,
           "noise_scale": 0.1, "anomaly_shift": 3.0}
#: the anomalous share of an offline test set (a choice, as WINDOWS is)
TEST_ANOMALY_SHARE = 0.3
#: the robot's drops among the tick cells' steps: 5 % of the steps, in runs
#: of 30 (3 s of a drop each; a choice, as WINDOWS is)
DROPS = {"share": 0.05, "segment_steps": 30}


def fused_windows(n: int, width: int, seed: int, tag: str, device,
                  anomaly_share: float = 0.0, params: dict = WINDOWS):
    """(n, width) fused windows and their labels (1 anomalous): ReLU
    features of a low-rank signal plus noise, as the fusion convs' outputs
    are (`params`, WINDOWS unless a test shrinks it).  The mixing matrix
    and bias are drawn once per run (tag "mix"), so every split shares one
    distribution; anomalous rows shift the latent by `anomaly_shift`.  One
    draw of each kind."""
    dev = torch.device(device)
    g_mix = generator(dev, seed, "mix")
    r = int(params["latent_rank"])
    mix = torch.randn(r, width, generator=g_mix, device=dev) / r ** 0.5
    bias = params["bias_scale"] * torch.randn(width, generator=g_mix,
                                              device=dev)
    g = generator(dev, seed, tag)
    z = torch.randn(n, r, generator=g, device=dev)
    labels = torch.rand(n, generator=g, device=dev) < anomaly_share
    z = z + params["anomaly_shift"] * labels[:, None].float()
    noise = torch.randn(n, width, generator=g, device=dev)
    x = torch.relu(params["signal_scale"] * (z @ mix) + bias
                   + params["noise_scale"] * noise)
    return x.contiguous(), labels


class SensorSteps:
    """`n` robot steps of 0.1 s, each what one `SimulatedSensors.tick()`
    pushes (a frozen copy of the port's `data/streaming.SimulatedSensors`
    distributions, drawn in bulk on `device` and brought to the host, where
    a robot's subscribers hand them over): the hand weight in newtons (0.1
    N resolution), a 32 x 32 RGB frame and a 32 x 32 depth frame (uint8),
    and CHUNKS int16 stereo mic chunks of 1024 frames.  Steps inside a drop
    (`anomaly`) carry its signature: the weight falls to 40 N, the frames
    brighten, the mic roars (and saturates)."""

    CHUNKS = 5
    CHUNK_SAMPLES = 2048
    #: steps drawn at a time, which bounds the draw's device memory
    BLOCK = 1024

    def __init__(self, n: int, seed: int, tag: str,
                 anomaly: Optional[dict] = None, device="cpu"):
        dev = torch.device(device)
        g = generator(dev, seed, tag)
        self.n = n
        drop = torch.zeros(n, dtype=torch.bool, device=dev)
        if anomaly and anomaly.get("share", 0) > 0:
            seg = int(anomaly["segment_steps"])
            n_seg = min(max(1, int(round(n * anomaly["share"] / seg))),
                        n // seg)
            for s in torch.randperm(max(n // seg, 1), generator=g,
                                    device=dev)[:n_seg].tolist():
                drop[s * seg:(s + 1) * seg] = True
        self.drop = drop.cpu().numpy()
        self.force = np.empty(n)
        self.hand = np.empty((n, 32, 32, 3), np.uint8)
        self.depth = np.empty((n, 32, 32), np.uint8)
        self.mic = np.empty((n, self.CHUNKS, self.CHUNK_SAMPLES), np.int16)
        for a in range(0, n, self.BLOCK):
            d = drop[a:a + self.BLOCK]
            b = d.shape[0]
            draw = lambda *shape: torch.randn(  # noqa: E731
                b, *shape, generator=g, device=dev, dtype=torch.float64)
            weight = torch.where(d, 40.0, 210.0).double()
            self.force[a:a + b] = (torch.round((weight + 2 * draw()) * 10)
                                   / 10).cpu().numpy()
            bright = torch.where(d, 180.0, 120.0).double()
            self.hand[a:a + b] = (bright[:, None, None, None]
                                  + 25 * draw(32, 32, 3)).clamp(0, 255).to(
                torch.uint8).cpu().numpy()
            self.depth[a:a + b] = (0.6 * bright[:, None, None]
                                   + 20 * draw(32, 32)).clamp(0, 255).to(
                torch.uint8).cpu().numpy()
            scale = torch.where(d, 8000.0, 300.0).float()
            self.mic[a:a + b] = (scale[:, None, None] * torch.randn(
                b, self.CHUNKS, self.CHUNK_SAMPLES, generator=g, device=dev)
            ).clamp(-32768, 32767).to(torch.int16).cpu().numpy()

    def chunk(self, index: int) -> np.ndarray:
        """The `index`-th mic chunk of the stream, the steps cycled."""
        step, j = divmod(index, self.CHUNKS)
        return self.mic[step % self.n, j]
