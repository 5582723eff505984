"""The port stands alone: every repro_torch module imports with jax blocked,
and no source of the port or of chip_smoke.py imports jax or repro."""
import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    for f in sorted(PKG.rglob("*.py")):
        rel = f.relative_to(ROOT / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_every_module_imports_without_jax():
    mods = list(_modules())
    assert len(mods) > 25
    assert {"repro_torch.models.mamba", "repro_torch.models.xlstm",
            "repro_torch.configs.xlstm_350m",
            "repro_torch.configs.jamba_v0_1_52b",
            "repro_torch.configs.gemma2_9b", "repro_torch.configs.llama3_405b",
            "repro_torch.configs.deepseek_67b",
            "repro_torch.configs.qwen2_vl_72b",
            "repro_torch.configs.llama4_scout_17b_a16e"} <= set(mods)
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "assert 'jax.numpy' not in sys.modules\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_sources_import_neither_jax_nor_repro():
    bad = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)[\s.])",
                     re.M)
    offenders = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
                 for f in SOURCES for m in bad.finditer(f.read_text())]
    assert not offenders, offenders


def test_kernel_sources_present_for_every_wrapper():
    from repro_torch.kernels import _build
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").exists(), name
    assert (_build.CSRC / "common.cuh").exists()
