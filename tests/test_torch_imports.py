"""The PyTorch port imports no JAX: every module of `mm_interleaved_tpu_torch`
(the entry points included) and `chip_smoke.py` import in a fresh process
where ``jax`` and ``mm_interleaved_tpu`` are blocked, as on the machine with
the card, which has no JAX.  ``nltk``, ``safetensors``, ``transformers``
and ``torchvision`` are blocked too (that machine has none of them): the
metrics, METEOR's stemmer included, run without nltk, and the checkpoint
reader reads a safetensors file without the package."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "nltk",
           "safetensors", "transformers", "torchvision", "mm_interleaved_tpu")
for name in BLOCKED:
    sys.modules[name] = None  # any import of them raises ImportError
import mm_interleaved_tpu_torch as pkg
names = sorted(m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                     pkg.__name__ + "."))
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
from mm_interleaved_tpu_torch.utils import metrics
assert metrics.meteor(["two dogs running"], [["a dog runs"]]) > 0
import os, tempfile, torch
from mm_interleaved_tpu_torch.utils import state_dict_io
path = os.path.join(tempfile.mkdtemp(), "w.safetensors")
state_dict_io.save_safetensors({"w": torch.ones(2).bfloat16()}, path)
assert torch.equal(state_dict_io.load_torch_state_dict(path)["w"],
                   torch.ones(2).bfloat16())
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED
                and sys.modules[m] is not None)
assert not loaded, loaded
print(" ".join(names))
"""


def test_port_imports_without_jax():
    """Every module imports; none of them loads JAX, the JAX package or
    nltk; METEOR runs."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    imported = set(out.stdout.split())
    for name in ("inference", "evaluate", "inference_loop", "train", "bench",
                 "generation.beam", "generation.scores", "engine.evaluator",
                 "parallel.inference", "utils.fid", "utils.metrics",
                 "utils.checkpoint", "utils.logging", "data.datasets",
                 "convert_checkpoint", "utils.state_dict_io",
                 "utils.name_map", "utils.convert_hf", "utils.convert_sd",
                 "utils.convert_ref", "utils.inception_v3",
                 "models.clip_text", "data.datasets_bench", "data.rices",
                 "prepare_ade20k", "ops.quant", "bench_int8_kernel",
                 "bench_v4_kernels", "parallel.partition",
                 "parallel.tensor"):
        assert f"mm_interleaved_tpu_torch.{name}" in imported, name
