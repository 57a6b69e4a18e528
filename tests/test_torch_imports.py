"""The port (thyroid_tpu_torch) and its scripts (chip_smoke.py,
chip_compare.py, scripts/torch_grad_condition.py) import nothing of JAX, flax or the JAX package, and every
port module imports without them. Nor do they import the decoders and
splitters the card's machine lacks (cv2, PIL, imageio, scikit-learn,
tifffile); only config/schemas.py imports pydantic, and the experiment
path imports without it. matplotlib is imported only inside the figure
functions (analysis/, the Trainer's attention-map logging)."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "thyroid_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py", ROOT / "chip_compare.py",
       ROOT / "scripts" / "torch_grad_condition.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "chex", "thyroid_tpu")
# absent on the card's machine
ABSENT = ("cv2", "PIL", "imageio", "sklearn", "tifffile")
SCHEMAS = ROOT / "thyroid_tpu_torch" / "config" / "schemas.py"


def _imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.unit
@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imported(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.unit
def test_package_imports_with_jax_blocked():
    """Every port module and the card scripts import in a process where
    importing jax, flax or thyroid_tpu fails."""
    code = (
        "import sys, pkgutil, importlib\n"
        f"for m in {FORBIDDEN!r}: sys.modules[m] = None\n"
        "import thyroid_tpu_torch as pkg\n"
        "for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(info.name)\n"
        "import chip_smoke, chip_compare\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r} and sys.modules[m] is not None]\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


@pytest.mark.unit
@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_absent_library_imports(path):
    """No port module imports what the card's machine lacks, and only
    config/schemas.py imports pydantic."""
    mods = [m.split(".")[0] for m in _imported(path)]
    bad = [m for m in mods if m in ABSENT
           or (m in ("pydantic", "pydantic_core") and path != SCHEMAS)]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.unit
def test_experiment_imports_without_pydantic():
    """The config package and the experiment path import, and compose a
    config, in a process where importing pydantic fails; the schemas
    raise ImportError only when asked for."""
    code = (
        "import sys\n"
        "for m in ('pydantic', 'pydantic_core'): sys.modules[m] = None\n"
        "import thyroid_tpu_torch.experiment\n"
        "from thyroid_tpu_torch import config\n"
        "cfg = config.compose(overrides=['model=cnn/efficientnet_b0'])\n"
        "assert cfg.model.name == 'efficientnet_b0'\n"
        "try:\n"
        "    config.DatasetConfig\n"
        "except ImportError:\n"
        "    pass\n"
        "else:\n"
        "    raise SystemExit('schemas imported without pydantic')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


@pytest.mark.unit
def test_sources_cover_every_experiment_module():
    """The scan above covers the stacked trainer and the ablation and
    all-models sweeps beside the k-fold experiment and its manager."""
    names = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    assert {f"thyroid_tpu_torch/{m}.py" for m in (
        "training/stacked", "training/checkpoint", "training/losses",
        "experiment/ablation_experiment", "experiment/all_models_experiment",
        "experiment/kfold_experiment", "experiment/manager")} <= names


@pytest.mark.unit
def test_package_imports_without_matplotlib():
    """Every port module, the analysis and its CLI included, imports in a
    process where importing matplotlib fails, and none imports it."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['matplotlib'] = None\n"
        "import thyroid_tpu_torch as pkg\n"
        "for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(info.name)\n"
        "import thyroid_tpu_torch.analysis.cli, thyroid_tpu_torch.data.quality_report\n"
        "bad = [m for m in sys.modules if m.startswith('matplotlib.')]\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


@pytest.mark.unit
def test_sources_cover_the_analysis():
    """The scans above cover the analysis package, its CLI and the
    quality report."""
    names = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    assert {f"thyroid_tpu_torch/{m}.py" for m in (
        "analysis/__init__", "analysis/gradcam", "analysis/attention",
        "analysis/evaluation", "analysis/cli", "data/quality_report")} <= names
