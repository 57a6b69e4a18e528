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
    """Every port module, the card scripts and the module the parallel
    tests' spawned ranks run (tests/torch_parallel_jobs.py) import in a
    process where importing jax, flax or thyroid_tpu fails."""
    code = (
        "import sys, pkgutil, importlib\n"
        f"for m in {FORBIDDEN!r}: sys.modules[m] = None\n"
        "import thyroid_tpu_torch as pkg\n"
        "for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(info.name)\n"
        "import chip_smoke, chip_compare, tests.torch_parallel_jobs\n"
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


@pytest.mark.unit
def test_sources_cover_the_serving_package():
    """The scans above cover the serving engine, int8 serving and the HTTP
    front end."""
    names = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    assert {f"thyroid_tpu_torch/serving/{m}.py" for m in (
        "__init__", "engine", "aggregator", "quantize", "server", "export",
        "export_serving")} <= names


@pytest.mark.unit
def test_server_runs_without_jax():
    """`python -m thyroid_tpu_torch.serving.server --help` in a process
    where importing jax, flax or thyroid_tpu fails; the models import
    `serving.quantize` without loading the engine (the package's names
    load lazily), the package exports JAX's eight serving names, and
    `python -m thyroid_tpu_torch.serving.export_serving --help` runs too."""
    code = (
        "import runpy, sys\n"
        f"for m in {FORBIDDEN!r}: sys.modules[m] = None\n"
        "import thyroid_tpu_torch.models.layers\n"
        "assert 'thyroid_tpu_torch.serving.engine' not in sys.modules\n"
        "import thyroid_tpu_torch.serving as s\n"
        "names = ('BatchAggregator', 'InferenceEngine', 'QuantConfig',\n"
        "         'int8_serving', 'quantized_apply', 'ExportedEngine',\n"
        "         'export_engine', 'load_exported')\n"
        "assert all(callable(getattr(s, n)) for n in names)\n"
        "for mod in ('export_serving', 'server'):\n"
        "    sys.argv = [mod, '--help']\n"
        "    try:\n"
        "        runpy.run_module(f'thyroid_tpu_torch.serving.{mod}', run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "--quantize" in out.stdout and "--device" in out.stdout
    assert "--bundle" in out.stdout and "--preprocessed" in out.stdout


@pytest.mark.unit
def test_bundle_loader_imports_no_model_code():
    """serving/export.py imports, at module level, the ops (whose
    definitions torch.export.load needs) and nothing of the models, the
    config tree, the data pipeline or the engine: those load only inside
    export_engine's caller."""
    tree = ast.parse((ROOT / "thyroid_tpu_torch/serving/export.py").read_text())
    local = [n.module for n in tree.body
             if isinstance(n, ast.ImportFrom) and n.level]
    assert local and all(m == "ops" or m.startswith("ops.") for m in local), local
    src = (ROOT / "thyroid_tpu_torch/serving/aggregator.py").read_text()
    assert "import" in src and "models" not in src and "engine import" not in src


@pytest.mark.unit
def test_warm_start_runs_without_jax_or_cv2(tmp_path):
    """models/import_torch.py is under the scans above, and a warm start
    runs in a process where importing jax, flax, thyroid_tpu, cv2 or PIL
    fails: a timm-named ViT-Ti checkpoint (224-style 4x4 grid, RGB, 1000
    classes) in a Lightning envelope into a gray 8x8-grid registry vit_tiny
    through create_and_init, its pos-embed resized at D = 192 (where JAX's
    importer calls cv2, inside the function, out of the scans' sight)."""
    assert ROOT / "thyroid_tpu_torch/models/import_torch.py" in SOURCES
    ckpt = str(tmp_path / "vit.ckpt")
    code = (
        "import sys\n"
        f"for m in {FORBIDDEN + ABSENT!r}: sys.modules[m] = None\n"
        "import torch\n"
        "from thyroid_tpu_torch.models.base import create_and_init\n"
        "D, g = 192, torch.Generator().manual_seed(0)\n"
        "r = lambda *s: 0.02 * torch.randn(*s, generator=g)\n"
        "sd = {'patch_embed.proj.weight': r(D, 3, 16, 16), 'patch_embed.proj.bias': r(D),\n"
        "      'cls_token': r(1, 1, D), 'pos_embed': r(1, 17, D),\n"
        "      'norm.weight': 1 + r(D), 'norm.bias': r(D),\n"
        "      'head.weight': r(1000, D), 'head.bias': r(1000)}\n"
        "for name, shape in (('norm1', (D,)), ('attn.qkv', (3 * D, D)),\n"
        "                    ('attn.proj', (D, D)), ('norm2', (D,)),\n"
        "                    ('mlp.fc1', (4 * D, D)), ('mlp.fc2', (D, 4 * D))):\n"
        "    sd[f'model.blocks.0.{name}.weight'] = r(*shape)\n"
        "    sd[f'model.blocks.0.{name}.bias'] = r(shape[0])\n"
        f"torch.save({{'state_dict': sd}}, {ckpt!r})\n"
        "m = create_and_init({'name': 'vit_tiny', 'img_size': 128, 'depth': 1,\n"
        "                     'in_channels': 1, 'num_classes': 2,\n"
        f"                     'pretrained_path': {ckpt!r}}}, device='cpu')\n"
        "assert tuple(m.pos_embed.shape) == (1, 65, D)\n"
        "assert m.cls_token.equal(sd['cls_token'])\n"
        "qkv = dict(m.named_parameters())['block_0.Attention_0.Dense_0.kernel']\n"
        "assert qkv.equal(sd['model.blocks.0.attn.qkv.weight'].T)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN + ABSENT!r} and sys.modules[m] is not None]\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


# the modules that join torch.distributed: the parallel package, the
# Trainer and the stacked trainer on a mesh, and device resolution under a
# process group
DISTRIBUTED = {"parallel/__init__", "parallel/mesh", "parallel/collectives",
               "parallel/multislice", "parallel/spawn", "training/engine",
               "training/stacked", "ops/platform"}


@pytest.mark.unit
def test_parallel_package_import_rules():
    """parallel/ (mesh, collectives, multislice, spawn) is under the scans
    above; torch.distributed is imported there and in the modules that
    train or resolve devices on a mesh, nowhere else; the spawned ranks'
    module imports no JAX, no JAX package module and no test module."""
    port = ROOT / "thyroid_tpu_torch"
    names = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    assert {f"thyroid_tpu_torch/{m}.py" for m in DISTRIBUTED} <= names
    users = set()
    for path in sorted(port.rglob("*.py")):
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            mods = [a.name for a in node.names] if isinstance(node, ast.Import) \
                else [node.module or ""] if isinstance(node, ast.ImportFrom) \
                and node.level == 0 else []
            if any(m == "torch.distributed" or m.startswith("torch.distributed.")
                   for m in mods):
                users.add(path.relative_to(port).with_suffix("").as_posix())
    assert users <= DISTRIBUTED, sorted(users - DISTRIBUTED)
    assert {"parallel/mesh", "parallel/collectives", "training/engine"} <= users
    jobs = ROOT / "tests" / "torch_parallel_jobs.py"
    mods = list(_imported(jobs))
    assert not [m for m in mods if m.split(".")[0] in FORBIDDEN], mods
    assert not [m for m in mods if m.startswith(("tests.test_", "tests.torch_parity"))]
