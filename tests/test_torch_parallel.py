"""The port's parallelism (thyroid_tpu_torch/parallel, the Trainer, the
stacked trainer and the serving engine on a mesh) on the CPU, against
JAX's functions (tests/unit/test_parallel.py's 8 virtual devices) and
against one process.

- host functions: partition_folds, merge_slice_summaries, stack_pytrees /
  unstack_pytree, the mesh size errors, the buckets a mesh engine rounds
  to, and fsdp_param_sharding on resnet18's tree, each equal to JAX's;
- one module-scoped spawn of 4 gloo ranks (tests/torch_parallel_jobs.py,
  one torch thread a rank) runs every multi-rank check while this
  process makes the one-process runs and JAX's {"data": 2} mesh step;
- serving: a two-CPU mesh engine in float32 and int8 against the
  no-mesh engine, and `server --data-parallel 2` answering a post.
"""
import http.client
import io
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_parallel_jobs as J
from tests.torch_parity import one_torch_thread  # noqa: F401
from thyroid_tpu import parallel as jpar
from thyroid_tpu_torch import parallel as par
from thyroid_tpu_torch.models.from_jax import jax_layout, to_jax_variables
from thyroid_tpu_torch.models.registry import ModelRegistry
from thyroid_tpu_torch.parallel.mesh import destroy_meshes
from thyroid_tpu_torch.serving import server as srv
from thyroid_tpu_torch.serving.engine import InferenceEngine

LOSS_TOL = 1e-5          # tests/unit/test_parallel.py's bound at lr 0
STATE_TOL = 1e-4         # of max|leaf|, parameters and running statistics


# ----------------------------------------------------------------------
# host functions against JAX's


@pytest.mark.unit
@pytest.mark.parametrize("k,s", [(5, 1), (5, 2), (6, 3), (7, 4), (2, 3)])
def test_partition_folds_matches_jax(k, s):
    for i in range(s):
        assert par.partition_folds(k, s, i) == jpar.partition_folds(k, s, i)
    for bad in (-1, s):
        with pytest.raises(ValueError, match="slice_index"):
            par.partition_folds(k, s, bad)
        with pytest.raises(ValueError, match="slice_index"):
            jpar.partition_folds(k, s, bad)


def _summary(folds, failed=()):
    rows = [{"error": "boom", "fold": f} if f in failed else
            {"fold": f, "test_acc": 0.5 + 0.1 * f, "val_loss": 1.0 / f,
             "val_auc": float("nan") if f == 2 else 0.7}
            for f in folds]
    return {"raw_fold_results": rows, "total_folds": 5,
            "experiment_name": "e", "model_name": "m"}


@pytest.mark.unit
@pytest.mark.parametrize("case", ["dicts", "paths", "all_failed"])
def test_merge_slice_summaries_matches_jax(case, tmp_path):
    """The slices' rows in fold order, avg_/std_ over the finite values of
    the successful folds, total_folds the max, and the all-failed
    sentinel, as JAX's merge gives them."""
    failed = (1, 2, 3, 4, 5) if case == "all_failed" else (3,)
    parts = [_summary([1, 3, 5], failed), _summary([2, 4], failed)]
    if case == "paths":
        for i, p in enumerate(parts):
            (tmp_path / f"s{i}.json").write_text(json.dumps(p))
        parts = [tmp_path / f"s{i}.json" for i in range(2)]
    got, want = par.merge_slice_summaries(parts), jpar.merge_slice_summaries(parts)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert [r["fold"] for r in got["raw_fold_results"]] == [1, 2, 3, 4, 5]
    if case == "all_failed":
        assert got["status"] == "All folds failed or no metrics"
    with pytest.raises(ValueError, match="no summaries"):
        par.merge_slice_summaries([])


@pytest.mark.unit
def test_stack_and_unstack_match_jax():
    rs = np.random.RandomState(0)
    trees = [{"w": rs.randn(3, 2).astype(np.float32), "b": rs.randn(2).astype(np.float32)}
             for _ in range(3)]
    got = par.stack_pytrees([{k: torch.from_numpy(v) for k, v in t.items()}
                             for t in trees])
    want = jpar.stack_pytrees(trees)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    for g, w in zip(par.unstack_pytree(got, 3), jpar.unstack_pytree(want, 3)):
        for k in w:
            np.testing.assert_array_equal(g[k], np.asarray(w[k]))


@pytest.mark.unit
def test_mesh_size_errors_match_jax():
    """A device mesh larger than its device list and a multislice mesh
    whose devices do not divide raise as JAX's do; a process mesh whose
    size is not the world's raises naming torchrun (a world of one here,
    from an in-memory store), and a world of one takes {"data": 1}."""
    cpus = ["cpu"] * 8
    for fn, args in ((par.create_mesh, ({"data": 99},)),):
        with pytest.raises(ValueError, match="needs 99 devices, have 8"):
            fn(*args, devices=cpus)
        with pytest.raises(ValueError, match="needs 99 devices, have 8"):
            jpar.create_mesh(*args)
    with pytest.raises(ValueError, match="do not divide into 4 slices"):
        par.multislice_mesh(4, devices=cpus[:6])
    with pytest.raises(ValueError, match="do not divide into 4 slices"):
        jpar.multislice_mesh(4, devices=jax.devices()[:6])
    mesh = par.multislice_mesh(2, devices=cpus)
    assert mesh.shape == jpar.multislice_mesh(2).shape == {"slice": 2, "data": 4}
    assert par.create_mesh(devices=cpus).shape == jpar.create_mesh().shape
    try:
        with pytest.raises(ValueError, match="needs 2 processes, have 1.*torchrun"):
            par.create_mesh({"data": 2}, backend="gloo")
        one = par.create_mesh({"data": 1}, backend="gloo")
        assert one.shape == {"data": 1} and one.coords == {"data": 0}
    finally:
        destroy_meshes()


@pytest.mark.unit
@pytest.mark.parametrize("n", [2, 3, 4])
def test_mesh_engine_buckets_round_as_jax(n, ranks):
    """Buckets rounded up to multiples of the shard count, at least one
    shard each: JAX's engine's own rounding, read off both engines (its
    module loaded by the `ranks` fixture, while the ranks run)."""
    from thyroid_tpu.serving.engine import InferenceEngine as JaxEngine

    buckets = (1, 2, 3, 5, 8, 32)
    model = ModelRegistry.create_model(J.NARROW)
    variables = to_jax_variables(model)
    want = JaxEngine(J.NARROW, variables=variables, buckets=buckets,
                     mesh=jpar.create_mesh({"data": n}), raw_inputs=False).buckets
    got = InferenceEngine(J.NARROW, variables=variables, buckets=buckets,
                          device="cpu", raw_inputs=False,
                          mesh=par.create_mesh({"data": n}, devices=["cpu"] * n)).buckets
    assert got == want


@pytest.mark.unit
def test_fsdp_param_sharding_matches_jax_on_resnet18():
    """resnet18's tree, leaf by leaf by JAX path: the port shards the dim
    that holds JAX's spec's sharded axis (conv kernels OIHW against
    HWIO, ties broken on JAX's order), and replicates where JAX does."""
    from thyroid_tpu.models.registry import ModelRegistry as JaxRegistry

    jm = JaxRegistry.create_model(J.RESNET18)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 32, 32, 1)), train=False))
    jmesh = jpar.create_mesh({"data": 4, "model": 2})
    specs = jpar.fsdp_param_sharding(jmesh, "model", shapes["params"])
    want = {"/".join(str(k.key) for k in path): spec.spec
            for path, spec in jax.tree_util.tree_leaves_with_path(specs)}
    model = ModelRegistry.create_model(J.RESNET18)
    layout = jax_layout(model)
    mesh = par.create_mesh({"data": 4, "model": 2}, devices=["cpu"] * 8)
    got = par.fsdp_param_sharding(mesh, "model", dict(model.named_parameters()),
                                  layout)
    assert len(got) == len(want)
    sharded = 0
    for name, dim in got.items():
        _, path, axes = layout[name]
        spec = tuple(want[path.replace(".", "/")])
        jax_dim = spec.index("model") if "model" in spec else None
        mine = None if dim is None else (dim if axes is None else axes[dim])
        assert mine == jax_dim, (name, dim, spec)
        sharded += dim is not None
    assert sharded > 20


# ----------------------------------------------------------------------
# the 4-rank spawn and its one-process and JAX counterparts


def _jax_mesh_step(root, monkeypatch):
    """JAX's Trainer on create_mesh({"data": 2}) from the port's seeded
    narrow ResNet: one SGD step on jax_batch → (loss, parameters and
    statistics before and after, by JAX path)."""
    import thyroid_tpu.training.engine as jax_engine
    from thyroid_tpu.models.registry import ModelRegistry as JaxRegistry
    from thyroid_tpu.training.metrics import zero_metric_state

    model = ModelRegistry.create_model(J.NARROW)
    model.init_weights(torch.Generator().manual_seed(42))
    variables = jax.tree.map(jnp.asarray, to_jax_variables(model))
    monkeypatch.setattr(jax_engine, "create_and_init",
                        lambda cfg, rng: (None, variables))
    make_state = jax_engine.create_train_state
    monkeypatch.setattr(jax_engine, "create_train_state",
                        lambda m, v, tx, ema: jax.jit(
                            lambda v: make_state(m, v, tx, ema))(v))
    mesh = jpar.create_mesh({"data": 2})
    jt = jax_engine.Trainer(
        JaxRegistry.create_model(J.NARROW), J.NARROW,
        {"epochs": 1, "batch_size": J.BATCH,
         "optimizer_params": {"name": "sgd", "lr": J.SGD_LR},
         "scheduler_params": None},
        {"max_epochs": 1, "enable_checkpointing": False, "precision": "f32",
         "gradient_clip_val": None}, steps_per_epoch=2, output_dir=root / "jax",
        mesh=mesh)
    sh = jpar.batch_sharding(mesh)
    x, y, w = (jax.device_put(a, sh) for a in J.jax_batch())
    state, m, _ = jt._train_step(jt.state, zero_metric_state(), x,
                                 y.astype(jnp.int32), w, jax.random.PRNGKey(0),
                                 jnp.float32(0.0))

    def flat(col, tree):
        return {f"{col}/{k}": np.asarray(v) for k, v in J._flat(
            jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)), tree)).items()}

    return {"loss": float(m["loss_sum"]) / float(m["w_sum"]),
            "before": {**flat("params", variables["params"]),
                       **flat("batch_stats", variables["batch_stats"])},
            "state": {**flat("params", state.params),
                      **flat("batch_stats", state.batch_stats)}}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(the 4 ranks' results, the one-process runs, JAX's step, root):
    the spawn runs in a thread while this process makes the rest."""
    root = tmp_path_factory.mktemp("mesh")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = J.trainer(root / "one", model=J.NARROW, lr=1e-3,
                        trainer_extra={"gradient_clip_val": J.CLIP})
        one.fit(*J.pipelines())
        one.save_state(root / "one.ckpt")
        out = {}

        def run():
            try:
                out["ranks"] = par.spawn("tests.torch_parallel_jobs:mesh_ranks",
                                         4, str(root), threads=1, timeout=900)
            except BaseException as e:          # re-raised below
                out["error"] = e

        spawn = threading.Thread(target=run)
        spawn.start()
        refs = {
            "lr0": J.fit_run(root / "r_lr0", data={"n_train": 16},
                             optimizer="sgd"),
            "lr": J.fit_run(root / "r_lr", lr=1e-3, arrays=True,
                            optimizer="sgd"),
            "distill": J.distill_run(root / "r_distill"),
            "draws": J.draws_run(root / "r_draws"),
            "stacked": J.stacked_run(root / "r_stacked"),
            "jax_step": J.jax_step_run(root / "r_step"),
        }
        cont = J.trainer(root / "r_cont", model=J.NARROW, lr=1e-3,
                         trainer_extra={"gradient_clip_val": J.CLIP})
        cont.resume_from(root / "one.ckpt")
        cont.fit(*J.pipelines())
        refs["continued"] = {"state": J.state_arrays(cont),
                             "moments": J.moments(cont)}
        with pytest.MonkeyPatch.context() as mp:
            jax_step = _jax_mesh_step(root, mp)
        import thyroid_tpu.serving.engine  # noqa: F401  (for the bucket test)
        spawn.join()
    finally:
        torch.set_num_threads(n)
    if "error" in out:
        raise out["error"]
    return out["ranks"], refs, jax_step, root


def _close_states(got, want, tol=STATE_TOL, keys=None):
    """Each leaf within tol·max|leaf| → the worst (ratio, leaf)."""
    worst = (0.0, "")
    for k in keys or want:
        scale = max(float(np.abs(want[k]).max()), 1e-12)
        r = float(np.abs(got[k] - want[k]).max()) / scale
        worst = max(worst, (r, k))
    assert worst[0] <= tol, worst
    return worst


def _losses(got, want, keys=("train_loss", "val_loss", "val_acc"), tol=LOSS_TOL):
    for k in keys:
        assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])


@pytest.mark.integration
@pytest.mark.parametrize("job", ["dp2_lr0", "dp4_lr0"])
def test_data_parallel_matches_one_process_at_lr0(ranks, job):
    """resnet18 at 32², batches of 16, lr 0, on {"data": 2} and
    {"data": 4}: train loss, val loss and val accuracy within 1e-5 of one
    process (JAX's own bound), the same on every rank of the job."""
    results, refs, _, _ = ranks
    got = [r[job] for r in results if job in r]
    assert len(got) == (2 if job == "dp2_lr0" else 4)
    for g in got:
        _losses(g, refs["lr0"])
        assert g == got[0]


@pytest.mark.integration
def test_local_batch_statistics_would_miss(ranks):
    """The same {"data": 2} run with each rank's BatchNorm on its own rows'
    statistics misses that bound: the global reduction is what holds it."""
    results, refs, _, _ = ranks
    local = results[2]["dp2_lr0_local"]
    assert abs(local["train_loss"] - refs["lr0"]["train_loss"]) > 100 * LOSS_TOL
    assert abs(local["val_loss"] - refs["lr0"]["val_loss"]) > 100 * LOSS_TOL


@pytest.mark.integration
def test_two_steps_match_one_process(ranks):
    """resnet18 at lr 1e-3 (SGD with momentum) after 2 steps on {"data":
    2}: losses within 1e-5, parameters and running statistics within 1e-4
    of max|leaf|; both ranks end with the same running statistics, bit
    for bit, and the same metrics."""
    results, refs, _, _ = ranks
    got, other = results[0]["dp2_lr"], results[1]["dp2_lr"]
    _losses(got, refs["lr"])
    _close_states(got["state"], refs["lr"]["state"])
    assert {k: v for k, v in other.items() if k != "stats"} == \
        {k: v for k, v in got.items() if k not in ("stats", "state")}
    assert got["stats"].keys() == other["stats"].keys()
    for k, v in got["stats"].items():
        np.testing.assert_array_equal(other["stats"][k], v, err_msg=k)


@pytest.mark.integration
def test_fsdp_matches_replicated_and_one_device(ranks):
    """{"data": 2, "model": 2} FSDP with clipping by norm (the clip acting)
    against {"data": 4} and against one device, each resuming the same
    one-device checkpoint for two more AdamW steps: loss within 1e-5,
    parameters, running statistics and the Adam moments (FSDP's blocks
    gathered) within 1e-4 of max|leaf|; the blocks are on JAX's dims."""
    results, refs, _, _ = ranks
    fsdp, rep = results[0]["fsdp"], results[0]["fsdp_replicated"]
    assert abs(fsdp["train_loss"] - rep["train_loss"]) <= LOSS_TOL
    _close_states(fsdp["state"], rep["state"])
    _close_states(fsdp["moments"], rep["moments"])
    _close_states(fsdp["state"], refs["continued"]["state"])
    _close_states(fsdp["moments"], refs["continued"]["moments"])
    assert len(fsdp["blocks"]) > 10 and not rep["blocks"]
    model = ModelRegistry.create_model(J.NARROW)
    mesh = par.create_mesh({"data": 2, "model": 2}, devices=["cpu"] * 4)
    want = par.fsdp_param_sharding(mesh, "model", dict(model.named_parameters()),
                                   jax_layout(model))
    assert fsdp["blocks"] == {n: d for n, d in want.items() if d is not None}


@pytest.mark.integration
def test_mesh_checkpoint_resumes_on_one_device(ranks):
    """The FSDP run's checkpoint, written whole by rank 0, resumes in a
    one-device Trainer: the same parameters, statistics, moments and
    step."""
    results, _, _, root = ranks
    t = J.trainer(root / "resume", model=J.NARROW, lr=1e-3)
    t.resume_from(root / "fsdp.ckpt")
    fsdp = results[0]["fsdp"]
    _close_states(J.state_arrays(t), fsdp["state"], tol=0.0)
    _close_states(J.moments(t), fsdp["moments"], tol=0.0)
    assert t.state.step == 4 and t.state.opt_state.count == 4


@pytest.mark.integration
def test_stacked_on_slice_data_mesh_matches_lockstep(ranks):
    """The stacked trainer on (slice 2, data 2), fold 0 on slice 0's data
    line and fold 1 on slice 1's, against the one-process lockstep run:
    every fold's row within 1e-5, on every rank, in fold order; each
    fold's checkpoint exported by its slice."""
    results, refs, _, _ = ranks
    want = refs["stacked"]
    assert [r["folds"] for r in want] == [[0, 1], [0, 1]]
    for rank, res in enumerate(results):
        got = res["stacked"]
        assert got[0]["folds"] == [rank // 2]
        for g, w in zip(got, want):
            assert g["exported"] and g["best_epoch"] == w["best_epoch"]
            for k, v in w.items():
                if k.startswith(("val_", "test_")):
                    assert abs(g[k] - v) <= LOSS_TOL, (rank, k, g[k], v)


@pytest.mark.integration
def test_distillation_matches_one_process(ranks):
    """Two distillation steps of a narrow DeiT (DropPath 0.2, each rank
    drawing the global batch's masks) under a frozen teacher replicated
    on each rank, {"data": 2} against one process: losses, the
    distillation term and the teacher agreement within 1e-5."""
    results, refs, _, _ = ranks
    for r in (results[2], results[3]):
        _losses(r["distill"], refs["distill"], keys=tuple(refs["distill"]))


@pytest.mark.integration
def test_draws_and_decisions_match_one_process(ranks):
    """Medium augmentation, MixUp/CutMix on the gathered batch, dropout,
    two-mini-step accumulation reduced at the boundary, a half-padded val
    batch (weight 0 rows on one rank only) and top-k checkpoints, two
    epochs on {"data": 2}: losses, accuracy and AUROC within 1e-5,
    parameters and statistics within 1e-4 of max|leaf|; both ranks
    decide the same best checkpoint, which rank 0 alone wrote."""
    results, refs, _, root = ranks
    got, want = results[2]["draws"], refs["draws"]
    _losses(got, want, keys=("train_loss", "val_loss", "val_acc", "val_auc"))
    _close_states(got["state"], want["state"])
    b2, b3 = results[2]["draws"]["best"], results[3]["draws"]["best"]
    assert b2.replace("draws_2", "") == b3.replace("draws_3", "")
    assert (root / "draws_2" / "checkpoints").is_dir()
    assert not (root / "draws_3" / "checkpoints").exists()


@pytest.mark.integration
def test_data_parallel_step_matches_jax_mesh(ranks):
    """The port's 2-rank step and JAX's Trainer step on
    create_mesh({"data": 2}) from the same weights and batch (narrow
    ResNet, SGD, float32), at tests/test_torch_resnet.py's one-device
    tolerances: the loss within 1e-4, the update's global difference
    within 1e-3 of its norm, the running statistics within 1e-4."""
    results, refs, jax_step, _ = ranks
    got = results[2]["jax_step"]
    assert abs(got["loss"] - jax_step["loss"]) <= 1e-4
    assert abs(got["loss"] - refs["jax_step"]["loss"]) <= LOSS_TOL
    for k, v in jax_step["before"].items():
        np.testing.assert_array_equal(got["before"][k], v, err_msg=k)
    params = [k for k in jax_step["state"] if k.startswith("params/")]
    du = np.concatenate([(got["state"][k] - got["before"][k]
                          - jax_step["state"][k] + jax_step["before"][k]).ravel()
                         for k in params])
    u = np.concatenate([(jax_step["state"][k] - jax_step["before"][k]).ravel()
                        for k in params])
    assert np.linalg.norm(du) <= 1e-3 * np.linalg.norm(u)
    for k in jax_step["state"]:
        if k.startswith("batch_stats/"):
            np.testing.assert_allclose(got["state"][k], jax_step["state"][k],
                                       atol=1e-4, rtol=1e-4, err_msg=k)


# ----------------------------------------------------------------------
# serving on a device mesh


def _frames(n=8):
    """Prepared 32² frames whose second shard of each 4-frame bucket has
    four times the maxima of the first."""
    rs = np.random.RandomState(5)
    fr = rs.rand(n, 32, 32, 1).astype(np.float32)
    fr[2:4] *= 4.0
    fr[6:8] *= 4.0
    return fr


@pytest.mark.unit
@pytest.mark.parametrize("quantize", [None, "int8"])
def test_mesh_engine_matches_plain_engine(quantize):
    """A mesh of the CPU twice: buckets of 3 round to 4, each bucket runs
    as two shards on their replicas, and the probabilities are within
    1e-6 of the no-mesh engine at bucket 4. In int8 the activation scale
    stays global over the bucket: the same bucket run as two separate
    halves (each its own scale) misses that bound."""
    mesh = par.create_mesh({"data": 2}, devices=["cpu", "cpu"])
    kw = dict(device="cpu", raw_inputs=False, quantize=quantize)
    plain = InferenceEngine(J.NARROW, buckets=(4,), **kw)
    sharded = InferenceEngine(J.NARROW, buckets=(3,), mesh=mesh, **kw)
    assert sharded.buckets == (4,) and len(sharded.replicas) == 1
    frames = _frames()
    want = plain.predict(frames)
    np.testing.assert_allclose(sharded.predict(frames), want, atol=1e-6, rtol=0)
    if quantize == "int8":
        halves = np.concatenate([plain.run(torch.from_numpy(frames[i:i + 2])).numpy()
                                 for i in range(0, 8, 2)])
        assert np.abs(halves - want).max() > 1e-3


@pytest.mark.unit
def test_shard_threads_under_stress():
    """More shard threads than cores, the interpreter switching every
    microsecond: an int8 bucket of 12 as 12 shards (each exchange of
    maxima a barrier of 12) equals the no-mesh engine, and 16 threads of
    launch counts lose no update."""
    import sys

    from thyroid_tpu_torch.ops import _build

    def counted():
        for _ in range(2000):
            _build.count_launch(counted)

    counted.launches = 0
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=counted) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert counted.launches == 16 * 2000
        mesh = par.create_mesh({"data": 12}, devices=["cpu"] * 12)
        kw = dict(device="cpu", raw_inputs=False, quantize="int8", buckets=(12,))
        frames = np.random.RandomState(8).rand(12, 32, 32, 1).astype(np.float32)
        frames[7] *= 5.0
        want = InferenceEngine(J.NARROW, **kw).predict(frames)
        got = InferenceEngine(J.NARROW, mesh=mesh, **kw).predict(frames)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    finally:
        sys.setswitchinterval(interval)


@pytest.mark.unit
def test_server_data_parallel_answers_a_post():
    """`server --data-parallel 2 --device cpu` (two CPU replicas) answers a
    post of 3 raw frames within 5e-7 of its engine's predict."""
    server, engine, aggregator = srv.build_server(
        ["--model", "resnet18", "--img-size", "32", "--buckets", "2", "4",
         "--data-parallel", "2", "--device", "cpu", "--port", "0",
         "--no-warmup"])
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        frames = (np.random.RandomState(6).rand(3, 48, 48, 1) * 4000).astype(np.float32)
        buf = io.BytesIO()
        np.save(buf, frames)
        conn = http.client.HTTPConnection(*server.server_address[:2], timeout=60)
        conn.request("POST", "/predict", body=buf.getvalue())
        reply = json.loads(conn.getresponse().read())
        conn.close()
        np.testing.assert_allclose(reply["probs"], engine.predict(frames),
                                   atol=5e-7, rtol=0)
        assert engine.buckets == (2, 4)
    finally:
        server.shutdown()
        aggregator.close()
        server.server_close()
        thread.join(timeout=10)
