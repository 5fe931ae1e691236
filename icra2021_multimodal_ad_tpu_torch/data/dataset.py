"""Tabular multimodal dataset manager: data_sum shards -> fused windows on
the card -> seeded index splits and loaders.

PyTorch counterpart of `icra2021_multimodal_ad_tpu/data/dataset.py` (the
reference's utils/data_loaders.py:233-598), on numpy, the stdlib and torch:

- every consecutive `data_sum{N}.csv` shard is read (`_shard_paths`), the
  light columns through the native reader (`data/fast_csv.py`), the 963
  LiDAR columns only for the LiDAR sensor;
- the optional object filter (`objectsplit.csv`), then the seeded
  `default_rng(seed).permutation` and the `slicing_size` cut, so the rows
  are JAX's rows in JAX's order;
- the per-row PNGs are decoded once per distinct path, in one batch, and
  frames of other sizes resized as PIL resizes them (`data/png.py`);
- normalization, resize and the fusion convs run on the device in one pass
  (`_preprocess_and_fuse`), with the projection drawn from `config.seed` as
  JAX draws it;
- a feature cache under `<data_folder_name>/.feature_cache`, keyed apart
  from the JAX package's entries;
- label-based 0.6/0.2/0.2 index splits, novelty-ratio rebalancing and
  three index loaders, all numpy draws, so the splits equal JAX's.
"""

from __future__ import annotations

import csv
import hashlib
import json
import os
import time
import zipfile
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from icra2021_multimodal_ad_tpu_torch.config import Config, load_data_registry
from icra2021_multimodal_ad_tpu_torch.data import fast_csv, png
from icra2021_multimodal_ad_tpu_torch.ops.fusion import (
    FusionParams,
    fuse,
    fusion_init,
)
from icra2021_multimodal_ad_tpu_torch.ops.image import (
    norm_minmax_per_column,
    resize_nearest,
)
from icra2021_multimodal_ad_tpu_torch.utils import fp32  # noqa: F401
from icra2021_multimodal_ad_tpu_torch.utils.device import (
    resolve_device,
    synchronize,
)

MFCC_COLS = [f"mfcc{i:02d}" for i in range(13)]
LIDAR_COLS = [f"LiDAR{i:03d}" for i in range(963)]
LIGHT_COLS = MFCC_COLS + [
    "cur_depth_id", "cur_hand_id", "cur_hand_weight", "data_dir", "label",
]


def _shard_paths(config: Config) -> List[str]:
    """data_sum0.csv, data_sum1.csv, ... while they exist (every one, not the
    reference's first 8); another `file_name` reads its shard 0 only."""
    file_name = config.file_name
    if file_name.endswith(".csv"):
        file_name = file_name[: -len(".csv")]
    if file_name != "data_sum":
        paths = [os.path.join(config.data_folder_name, file_name + "0.csv")]
    else:
        paths, i = [], 0
        while os.path.exists(os.path.join(config.data_folder_name,
                                          f"{file_name}{i}.csv")):
            paths.append(os.path.join(config.data_folder_name,
                                      f"{file_name}{i}.csv"))
            i += 1
    if not paths or not os.path.exists(paths[0]):
        raise FileNotFoundError(
            f"no {file_name}*.csv shards under {config.data_folder_name}")
    return paths


def _object_keep(config: Config) -> set:
    """The episode names of `config.object_type` in objectsplit.csv.  Names
    compare as text: an episode written "007" in one file and "7" in the
    other does not match (pandas would read both as 7)."""
    path = os.path.join(config.data_folder_name, "objectsplit.csv")
    with open(path, "r", newline="") as f:
        rows = list(csv.DictReader(f))
    return {r[config.object_type].strip() for r in rows
            if (r.get(config.object_type) or "").strip()}


def _read_shards(config: Config):
    """(columns, lidar, readers): the light columns of every shard,
    concatenated, filtered, shuffled and sliced as the JAX package does;
    lidar is a float32 (N, 963) matrix for the LiDAR sensor, else None;
    readers names the reader of each shard ("native" or "csv")."""
    paths = _shard_paths(config)
    frames = [fast_csv.read_light_frame(p, LIGHT_COLS) for p in paths]
    cols = {c: np.concatenate([f.columns[c] for f in frames])
            for c in frames[0].columns}
    lidar = None
    if config.sensor == "LiDAR":
        lidar = np.concatenate([fast_csv.read_columns(p, LIDAR_COLS)
                                for p in paths], axis=0)
    if config.object_select_mode:
        keep = np.isin(cols["data_dir"], sorted(_object_keep(config)))
        cols = {c: v[keep] for c, v in cols.items()}
        if lidar is not None:
            lidar = lidar[keep]
    n = len(cols["label"])
    perm = np.random.default_rng(config.seed).permutation(n)
    perm = perm[: max(config.slicing_size, 0)]
    cols = {c: v[perm] for c, v in cols.items()}
    if lidar is not None:
        lidar = lidar[perm]
    return cols, lidar, [f.reader for f in frames]


#: bump when the cached array contents change meaning (layout, dtype, ...)
FEATURE_CACHE_VERSION = 1


def _fusion_fingerprint(params: FusionParams) -> str:
    """Content hash of caller-supplied fusion weights."""
    h = hashlib.sha256()
    for p in params:
        for k in sorted(p):
            h.update(p[k].detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _feature_cache_key(config: Config, paths: Sequence[str],
                       fusion_fp: str) -> str:
    """Everything the fused features depend on: the shards' identities
    (path, size, mtime), the object filter, seed, sensor, slicing and the
    fusion weights.  The "package" entry keeps the port's keys apart from
    the JAX package's, so neither reads the other's entries.  Edits to the
    per-row PNGs are not tracked: delete .feature_cache after editing
    them."""
    files = []
    for p in paths:
        st = os.stat(p)
        files.append((os.path.abspath(p), st.st_size, st.st_mtime_ns))
    if config.object_select_mode:
        op = os.path.join(config.data_folder_name, "objectsplit.csv")
        st = os.stat(op)
        files.append((os.path.abspath(op), st.st_size, st.st_mtime_ns))
    spec = {
        "package": "icra2021_multimodal_ad_tpu_torch",
        "v": FEATURE_CACHE_VERSION,
        "sensor": config.sensor,
        "seed": config.seed,
        "slicing_size": config.slicing_size,
        "object_select_mode": bool(config.object_select_mode),
        "object_type": (config.object_type if config.object_select_mode
                        else None),
        "files": files,
        "fusion": fusion_fp,
    }
    blob = json.dumps(spec, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:24]


def _feature_cache_path(config: Config, key: str) -> str:
    return os.path.join(config.data_folder_name, ".feature_cache",
                        f"features_{key}.npz")


def image_paths(root: str, data_dirs, ids, subdir: str) -> List[str]:
    """<root>/data/<dir>/data/img/<subdir>/<id>.png of every row."""
    return [os.path.join(root, "data", str(d), "data", "img", subdir,
                         f"{int(i)}.png") for d, i in zip(data_dirs, ids)]


def _load_images(root: str, data_dirs, ids, subdir: str) -> np.ndarray:
    """uint8 (N, 24, 32[, 3]) frames of the rows, resized as PIL resizes
    frames of other sizes; each distinct path (a slower camera repeats its
    frame across 10 Hz windows) is decoded once, all of them in one batch.
    The files are read serially: a thread pool measured slower on both the
    test host and the card's, whose file opens serialize (CHANGES.md, the
    frontend's entry: ~216 us an open and read, ~17 us a decode)."""
    paths = image_paths(root, data_dirs, ids, subdir)
    unique = list(dict.fromkeys(paths))
    decoded = dict(zip(unique, png.decode_resized_batch(unique, (32, 24))))
    return np.stack([decoded[p] for p in paths])


def preprocess(*, raw_r=None, raw_d=None, weight=None, mfcc=None,
               lidar=None) -> dict:
    """Per-column min-max over the batch, HWC -> CHW and nearest resize of
    the 24 x 32 frames to 32 x 32: the fusion inputs (`fuse`'s r, d, t, m,
    l) from the raw columns, on their device."""
    kw = {}
    if raw_r is not None:
        r = norm_minmax_per_column(raw_r.reshape(raw_r.shape[0], -1))
        r = r.reshape(-1, 24, 32, 3).permute(0, 3, 1, 2)
        kw["r"] = resize_nearest(r, 32, 32)
    if raw_d is not None:
        d = norm_minmax_per_column(raw_d.reshape(raw_d.shape[0], -1))
        kw["d"] = resize_nearest(d.reshape(-1, 1, 24, 32), 32, 32)
    if weight is not None:
        kw["t"] = norm_minmax_per_column(weight)
    if mfcc is not None:
        kw["m"] = norm_minmax_per_column(mfcc)[:, None, :]
    if lidar is not None:
        kw["l"] = norm_minmax_per_column(lidar)[:, None, :]
    return kw


def _preprocess_and_fuse(params: FusionParams, *, sensor: str,
                         **raw) -> torch.Tensor:
    """`preprocess`, then the fusion convs: (N, input_size) fp32 features."""
    return fuse(params, sensor=sensor, **preprocess(**raw))


#: what an unreadable cache entry raises; the build then runs anew
_CACHE_ERRORS = (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile,
                 zlib.error)


class TabularDataset:
    """Shards -> fused features on `device`, the card unless the caller
    asks for the CPU (data_loaders.py:233-463).

    Attributes: `data` (N, feat) fp32 and `targets` (N,) fp32 on the
    device; `columns`, the light columns as numpy, in row order; `readers`,
    the CSV reader of each shard ("native" or "csv"; empty on a cache hit);
    `png_unfilter`, the PNG unfilter that decoded the frames ("native" or
    "numpy"; None without frames); `cache_hit`; `seconds`, the host time of
    each build step."""

    def __init__(self, config: Config,
                 fusion_params: Optional[FusionParams] = None,
                 device="cuda"):
        dev = resolve_device(device)
        sensor = config.sensor
        t_start = time.perf_counter()
        if fusion_params is None:
            fusion_params = fusion_init(config.seed, dev)
            # the replay draws JAX's weights for the seed, so the seed names
            # them
            fusion_fp = f"jax-prng-replay:{config.seed}"
        else:
            fusion_params = fusion_params.to(dev)
            fusion_fp = _fusion_fingerprint(fusion_params)
        self.fusion_params = fusion_params
        self.readers: List[str] = []
        self.png_unfilter: Optional[str] = None
        self.cache_hit = False
        self.seconds: Dict[str, float] = {}

        cache_path = None
        if config.feature_cache:
            key = _feature_cache_key(config, _shard_paths(config), fusion_fp)
            cache_path = _feature_cache_path(config, key)
            if os.path.exists(cache_path):
                try:
                    self._read_cache(cache_path, dev)
                    self.cache_hit = True
                    self.seconds["total"] = time.perf_counter() - t_start
                    if config.verbose >= 1:
                        print(f"feature cache hit: {cache_path}")
                    return
                except _CACHE_ERRORS as e:
                    # the cache is an optimization: a corrupt entry means a
                    # rebuild, never a crash
                    print(f"feature cache unreadable "
                          f"({type(e).__name__}: {e}); rebuilding")

        t0 = time.perf_counter()
        cols, lidar, self.readers = _read_shards(config)
        self.seconds["read_csv"] = time.perf_counter() - t0
        self.columns = cols

        t0 = time.perf_counter()
        host = {}
        if sensor in ("All", "hand_camera", "head_depth"):
            self.png_unfilter = png.unfilter_route()
        if sensor in ("All", "hand_camera"):
            host["raw_r"] = _load_images(config.data_folder_name,
                                         cols["data_dir"], cols["cur_hand_id"],
                                         "hand")
        if sensor in ("All", "head_depth"):
            host["raw_d"] = _load_images(config.data_folder_name,
                                         cols["data_dir"],
                                         cols["cur_depth_id"], "d")
        self.seconds["decode_png"] = time.perf_counter() - t0
        if sensor in ("All", "force_torque"):
            host["weight"] = cols["cur_hand_weight"][:, None].astype(
                np.float32)
        if sensor in ("All", "mic"):
            host["mfcc"] = np.stack([cols[c] for c in MFCC_COLS],
                                    axis=1).astype(np.float32)
        if sensor == "LiDAR":
            host["lidar"] = np.asarray(lidar, dtype=np.float32)

        t0 = time.perf_counter()
        kw = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
              for k, v in host.items()}
        self.targets = torch.from_numpy(
            cols["label"].astype(np.float32)).to(dev)
        synchronize(dev)
        self.seconds["upload"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.data = _preprocess_and_fuse(fusion_params, sensor=sensor, **kw)
        synchronize(dev)
        self.seconds["fuse"] = time.perf_counter() - t0

        if cache_path is not None:
            self._write_cache(cache_path)
        self.seconds["total"] = time.perf_counter() - t_start

    def _read_cache(self, path: str, dev: torch.device) -> None:
        with np.load(path, allow_pickle=False) as z:
            data = torch.from_numpy(z["data"]).to(dev)
            targets = torch.from_numpy(z["targets"]).to(dev)
            columns = {str(c): z[f"col_{c}"] for c in z["light_columns"]}
        self.data, self.targets, self.columns = data, targets, columns

    def _write_cache(self, path: str) -> None:
        """Atomic npz write (tmp + rename): concurrent builders of one key
        see nothing or a whole file."""
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                np.savez(f, data=self.data.cpu().numpy(),
                         targets=self.targets.cpu().numpy(),
                         light_columns=np.asarray(list(self.columns)),
                         **{f"col_{c}": v for c, v in self.columns.items()})
            os.replace(tmp, path)
        except OSError as e:
            # a read-only data dir: the cache is an optimization
            print(f"feature cache write skipped ({e})")

    def __len__(self):
        return len(self.targets)

    def __getitem__(self, idx):
        return self.data[idx], self.targets[idx]


class ArrayLoader:
    """Index-batched view over (data, targets): the reference's DataLoader
    with a Subset or Sequential sampler (data_loaders.py:141-149)."""

    def __init__(self, data: torch.Tensor, targets: torch.Tensor,
                 indices: Sequence[int], batch_size: int,
                 shuffle: bool = False, seed: int = 0):
        self.data = data
        self.targets = targets
        self.indices = np.asarray(indices, dtype=np.int64)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return (len(self.indices) + self.batch_size - 1) // self.batch_size

    def _take(self, idx: np.ndarray):
        sel = torch.from_numpy(idx).to(self.data.device)
        return self.data[sel], self.targets[sel]

    def __iter__(self):
        idx = self.indices
        if self.shuffle:
            idx = self._rng.permutation(idx)
        for s in range(0, len(idx), self.batch_size):
            yield self._take(idx[s: s + self.batch_size])

    def gather(self):
        """(x, y) of all rows in sampler order: the reference's
        get_transformed_data (data_loaders.py:528-552)."""
        return self._take(self.indices)


class TabularDatasetManager:
    """Owner of the full (x, y) tensors and the index bookkeeping
    (data_loaders.py:465-598)."""

    def __init__(self, config: Config,
                 fusion_params: Optional[FusionParams] = None,
                 dataset: Optional[TabularDataset] = None, device="cuda"):
        self.config = config
        self.train_dataset = dataset or TabularDataset(config, fusion_params,
                                                       device=device)
        self.total_x = self.train_dataset.data
        self.total_y = self.train_dataset.targets
        self.total_size = len(self.total_x)

    def get_indexes(self, ratios: Optional[List[float]] = None, labels=None):
        """Label-filtered index splits (data_loaders.py:507-526)."""
        y = self.total_y.cpu().numpy()
        if labels is not None:
            if not hasattr(labels, "__iter__"):
                labels = [labels]
            indexes = list(np.where(np.isin(y, list(labels)))[0])
        else:
            indexes = list(range(self.total_size))
        if ratios:
            if abs(sum(ratios) - 1) >= 1e-9:
                raise ValueError(f"ratios must sum to 1, got {ratios}")
            if len(ratios) == 1:
                return [indexes]
            cuts = (np.cumsum(ratios)[:-1] * len(indexes)).astype(int)
            return [list(part) for part in np.split(np.asarray(indexes), cuts)]
        return [indexes]

    def get_transformed_data(self, loader: ArrayLoader):
        return loader.gather()

    def get_loaders(self, batch_size: int, ratios=None, indexes_list=None):
        if ratios and indexes_list:
            raise ValueError(
                "Only either `ratios` or `indexes_list` is allowed")
        if ratios:
            indexes_list = self.get_indexes(ratios=ratios)
        return [ArrayLoader(self.total_x, self.total_y, idx, batch_size,
                            shuffle=(i == 0), seed=self.config.seed + i)
                for i, idx in enumerate(indexes_list)]


def get_balance(seen_index_list, unseen_index_list, novelty_ratio: float = 0.5,
                seed: int = 0):
    """Novelty-ratio rebalancing of the test split (data_loaders.py:31-48)
    with seeded subsampling; with one side empty there is nothing to
    balance, and novelty_ratio >= 1 is refused."""
    if novelty_ratio <= 0.0:
        return seen_index_list, unseen_index_list
    if novelty_ratio >= 1.0:
        raise ValueError("novelty_ratio must be < 1 (the rebalance keeps "
                         "at least some normal rows)")
    if not seen_index_list or not unseen_index_list:
        return seen_index_list, unseen_index_list
    rng = np.random.default_rng(seed)
    n_seen, n_unseen = len(seen_index_list), len(unseen_index_list)
    current = n_unseen / (n_seen + n_unseen)
    if current < novelty_ratio:
        target_seen = int(n_unseen / novelty_ratio - n_unseen)
        return (list(rng.choice(seen_index_list, target_seen, replace=False)),
                unseen_index_list)
    if current > novelty_ratio:
        target_unseen = int((n_seen * novelty_ratio) / (1 - novelty_ratio))
        return (seen_index_list,
                list(rng.choice(unseen_index_list, target_unseen,
                                replace=False)))
    return seen_index_list, unseen_index_list


def get_loaders(config: Config, use_full_class: bool = False,
                fusion_params: Optional[FusionParams] = None,
                registry_path: Optional[str] = None, device="cuda"):
    """Top-level loader construction (data_loaders.py:50-138): registry
    lookup, seen/unseen label split against target_class, 0.6/0.2/0.2
    splits, novelty balancing; returns (manager, train, valid, test), the
    features on `device`."""
    registry = load_data_registry(registry_path)
    if config.data not in registry:
        raise ValueError("no dataset config for " + config.data)
    data_config = registry[config.data]

    class_list = data_config["labels"]
    seen_labels, unseen_labels = [], []
    target = config.target_class
    if target not in class_list:
        target = (class_list[1] if config.data == "hsr_objectdrop"
                  else class_list[0])
        config = config.replace(target_class=target)
    for c in class_list:
        if use_full_class:
            seen_labels.append(c)
        elif (c != target) != config.unimodal_normal:
            seen_labels.append(c)
        else:
            unseen_labels.append(c)

    if data_config["from"] != "youngjae":
        raise NotImplementedError(
            f"dataset source {data_config['from']!r}: only the youngjae "
            "(hsr_objectdrop CSV) pipeline has a live code path, as in the "
            "reference (data_loaders.py:84-89)")
    manager = TabularDatasetManager(config, fusion_params, device=device)

    seen = manager.get_indexes(labels=seen_labels, ratios=[0.6, 0.2, 0.2])
    if use_full_class:
        indexes_list = seen
    else:
        unseen = manager.get_indexes(labels=unseen_labels)
        if config.verbose >= 2:
            _print_balance("Before", seen, unseen)
        seen[2], unseen[0] = get_balance(seen[2], unseen[0],
                                         config.novelty_ratio,
                                         seed=config.seed)
        if config.verbose >= 1:
            _print_balance("After", seen, unseen)
        indexes_list = [seen[0], seen[1], list(seen[2]) + list(unseen[0])]

    train, valid, test = manager.get_loaders(batch_size=config.batch_size,
                                             indexes_list=indexes_list)
    return manager, train, valid, test


def _print_balance(tag, seen, unseen):
    denom = len(unseen[0]) + len(seen[2])
    ratio = len(unseen[0]) / denom if denom else 0.0
    print(f"{tag} balancing:\t|train|={len(seen[0])} |valid|={len(seen[1])} "
          f"|test_normal|={len(seen[2])} |test_novelty|={len(unseen[0])} "
          f"|novelty_ratio|={ratio:.4f}")
