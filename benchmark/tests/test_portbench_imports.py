"""What a run and the reference load: no JAX and no JAX package, compared
by whole top-level names; and the reference none of the port."""

import os
import subprocess
import sys

from benchmark.harness.cli import forbidden_modules

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
PORT = "icra2021_multimodal_ad_tpu_torch"


def test_top_level_names_compare_whole():
    assert forbidden_modules([PORT, PORT + ".ops.serving", "jaxtyping",
                              "flaxen", "numpy"]) == []
    assert forbidden_modules(["jax.numpy", "jaxlib", "flax.linen",
                              "icra2021_multimodal_ad_tpu.ops"]) == [
        "flax", "icra2021_multimodal_ad_tpu", "jax", "jaxlib"]


def _loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True,
        env={**os.environ, "PYTHONPATH": ROOT})
    return set(out.stdout.split())


def test_reference_loads_nothing_of_the_port_or_jax():
    loaded = _loaded_after(
        "import benchmark.reference.ae, benchmark.reference.frontend, "
        "benchmark.reference.nap, benchmark.reference.prng, "
        "benchmark.reference.compare, benchmark.reference.precision")
    assert PORT not in loaded
    assert not forbidden_modules(loaded)


def test_a_whole_run_loads_no_jax():
    code = (
        "import time\n"
        "from benchmark.harness import cli\n"
        "from benchmark.harness.manifest import Manifest\n"
        "r = cli.run_cell(Manifest('.'), 'all_1728.train', 2**31 + 5, 0.1,"
        " False, 'cpu', time.perf_counter(), {'config': {'input_size': 24,"
        " 'n_layers': 2, 'btl_size': 4, 'batch_size': 32, 'n_epochs': 2},"
        " 'traffic': {'train_windows': 70, 'valid_windows': 20}})\n"
        "assert r is not None\n")
    loaded = _loaded_after(code)
    assert PORT in loaded
    assert not forbidden_modules(loaded)
