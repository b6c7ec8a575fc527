"""Nothing the benchmark runs loads JAX or the JAX package; names are
compared whole, by the part before the first dot."""
import subprocess
import sys

from benchmark import run

MODULES = ["benchmark.run", "benchmark.serve", "benchmark.calibrate", "benchmark.flops",
           "benchmark.reference", "soccdpt_torch.serving"]


def test_harness_imports_no_jax():
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in MODULES)
            + "from benchmark import spec, run\n"
            + "for w in ['beitl512.rig6.20hz.grid', 'swin2t.backlog.b6.grid']:\n"
            + "    spec.readers(spec.load(run.ROOT, w))\n"
            + "print(sorted({n.split('.', 1)[0] for n in sys.modules}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    tops = set(eval(proc.stdout.strip().splitlines()[-1]))
    assert not tops & set(run.FORBIDDEN)
    assert "soccdpt_torch" in tops  # a prefix of a forbidden name is not forbidden


def test_forbidden_compares_whole_names(monkeypatch):
    before = run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxfoo", object())
    monkeypatch.setitem(sys.modules, "soccdpt_tpux.sub", object())
    assert run.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "soccdpt_tpu.models", object())
    assert "soccdpt_tpu" in run.forbidden_modules()
