"""The program under test: the PyTorch/CUDA port, built from the run's
configuration and the weights `inputs` drew.  These adapters are the only
place the harness core names the port's configuration and model layout; the
entries import the port's entry points themselves."""

from __future__ import annotations

from typing import List

import torch


def port_config(config: dict, **overrides):
    """The port's `Config` for a benchmark configuration file's keys."""
    from icra2021_multimodal_ad_tpu_torch.config import Config

    fields = dict(sensor=config["sensor"], input_size=config["input_size"],
                  n_layers=config["n_layers"], btl_size=config["btl_size"],
                  batch_size=config["batch_size"],
                  n_epochs=config["n_epochs"], lr=config["lr"],
                  slicing_size=config["slicing_size"],
                  nap_fit_method=config["nap_fit_method"],
                  compute_dtype=config["dtype"], train_dtype=config["dtype"],
                  param_dtype=config["dtype"])
    fields.update(overrides)
    return Config(**fields)


def port_model(config: dict, weights: List[dict], device):
    """The port's eval-mode `AutoEncoder` of `config` holding `weights`
    (copies: the program's training changes its own)."""
    from icra2021_multimodal_ad_tpu_torch.models.builder import (
        build_autoencoder,
    )

    model = build_autoencoder(port_config(config)).to_empty(
        device=torch.device(device))
    load_weights(model, weights)
    return model.eval()


@torch.no_grad()
def load_weights(model, weights: List[dict]) -> None:
    """Copy `weights` into the port's model in place: the FC layers, the BN
    affine and running statistics, and a zero batch count."""
    modules = {"encoder": model.encoder, "decoder": model.decoder}
    for l in weights:
        fc = modules[l["module"]].net[l["index"]]
        fc.layer.weight.copy_(l["w"])
        fc.layer.bias.copy_(l["b"])
        if l["bn"] is not None:
            fc.bn.weight.copy_(l["bn"]["weight"])
            fc.bn.bias.copy_(l["bn"]["bias"])
            fc.bn.running_mean.copy_(l["bn"]["mean"])
            fc.bn.running_var.copy_(l["bn"]["var"])
            fc.bn.num_batches_tracked.zero_()


def port_fusion(fusion: dict):
    """The port's `FusionParams` of the drawn fusion weights."""
    from icra2021_multimodal_ad_tpu_torch.ops.fusion import FusionParams

    return FusionParams(**{name: {"w": p["w"].contiguous(),
                                  "b": p["b"].contiguous()}
                           for name, p in fusion.items()})


def launch_counts() -> dict:
    """The port's kernel launch counters (`utils/graphs.COUNTERS`), which a
    graph replay adds its capture's launches to: {"fn.attr": count}."""
    from icra2021_multimodal_ad_tpu_torch.utils import graphs

    return {f"{getattr(fn, '__name__', fn)}.{attr}": getattr(fn, attr)
            for fn, attr in graphs.COUNTERS}
