"""What the benchmark loads: never JAX or the JAX package, and the
reference nothing of the port."""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"


def loaded_after(code):
    """Top-level names of sys.modules after ``code``, in a fresh process."""
    prog = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, "
            f"{str(ROOT / 'src')!r}]\n{code}\n"
            "import json; print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_every_module_of_the_benchmark_and_the_served_chain_loads_no_jax():
    kinds = ("loops", "metrics", "roofline", "flops", "reference")
    code = "\n".join(
        ["import bench.run, bench.control, bench.harness, bench.check",
         "import repro_torch.models.lm, repro_torch.kernels.ops",
         "from bench import core"]
        + [f"core.load_module({kind!r}, {p.stem!r})"
           for kind in kinds for p in sorted((BENCH / kind).glob("*.py"))
           if p.stem != "__init__"])
    found = loaded_after(code)
    assert {"bench", "repro_torch", "torch"} <= found
    assert not found & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_imports_nothing_of_the_port():
    found = loaded_after(
        "from bench.reference import ssm, hybrid, layers\n"
        "import bench.weights, bench.check")
    assert not found & {"repro_torch", "repro", "jax", "jaxlib"}
