"""Nothing the harness runs loads JAX or the JAX package."""

import json
import subprocess
import sys
import textwrap

from portbench import harness
from portbench.tests.helpers import ROOT

# Drives both cells on the CPU, traced and not, then lists the loaded
# modules' top-level names, in a fresh interpreter.
PROGRAM = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, sys.argv[1])
    import torch
    from portbench import calibrate, harness, run
    from portbench.tests.helpers import small
    for cell in ("health.matmul", "extended.dma_copy"):
        for trace in (False, True):
            harness.run_cell(cell, 5, 0.1, trace, torch.device("cpu"),
                             overrides=small(cell),
                             peaks={"bf16_dense_tflops": 1e6,
                                    "hbm_gbps": 1e6})
    print(json.dumps(sorted({m.partition(".")[0] for m in sys.modules})))
""")


def test_a_run_loads_no_jax_and_no_jax_package():
    out = subprocess.run([sys.executable, "-c", PROGRAM, str(ROOT)],
                         capture_output=True, text=True, timeout=300,
                         check=True, cwd=ROOT)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "tpufd_torch" in loaded and "portbench" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "tpufd"}


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpufd_torch_probe", object())
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    monkeypatch.delitem(sys.modules, "tpufd", raising=False)
    before = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_modules() == sorted(set(before) | {"jax"})
