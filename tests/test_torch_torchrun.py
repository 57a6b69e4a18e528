"""The documented multi-process launch on the CPU: `torchrun
--nproc-per-node 2` over `launch_experiment` (tests/torch_parallel_jobs.py
`launch_main`) with `trainer.mesh_shape={data: 2}`, on a corpus and fold
directory that do not exist yet. Rank 0 alone writes the corpus and the
fold files (each rank joins the group before it asks), one summary
comes out, and both ranks return the same fold rows."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from tests.torch_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
JOBS = ROOT / "tests" / "torch_parallel_jobs.py"


@pytest.mark.unit
def test_torchrun_experiment_writes_shared_files_once(tmp_path):
    out = tmp_path / "rows"
    out.mkdir()
    overrides = [
        "model=cnn/efficientnet_b0", "dataset=synthetic_tiny", "training=cnn",
        "augmentation=no_aug", "trainer.max_epochs=1", "kfold.num_folds=2",
        f"dataset.data_path={tmp_path / 'synthetic'}",
        f"dataset.split_dir={tmp_path / 'splits'}",
        f"kfold.split_dir={tmp_path / 'splits'}",
        f"output_dir={tmp_path / 'out'}", "dataset.synthetic_size=16",
        "training.batch_size=4", "model.img_size=32", "+model.width_mult=0.25",
        "+model.depth_mult=0.3", "+model.dtype=f32",
        "trainer.mesh_shape={data: 2}"]
    # the launcher's log folders go under tmp_path
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               TMPDIR=str(tmp_path))
    # --standalone: a rendezvous on a free localhost port
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", str(JOBS), str(out), *overrides],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    log = proc.stdout + proc.stderr
    assert proc.returncode == 0, log[-4000:]
    assert log.count("generating synthetic corpus") == 1, log[-4000:]
    assert log.count("generated 2 fold split files") == 1, log[-4000:]
    assert sorted(p.name for p in (tmp_path / "splits").iterdir()) == \
        ["split_fold_1.json", "split_fold_2.json"]
    assert len(list((tmp_path / "out").rglob("kfold_summary_*.json"))) == 1
    rows = [json.loads((out / f"rank{r}.json").read_text()) for r in (0, 1)]
    assert rows[0] == rows[1]
    assert [r["fold"] for r in rows[0]] == [1, 2]
    assert not any("error" in r for r in rows[0])
