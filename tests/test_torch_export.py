"""The port's serving export (thyroid_tpu_torch/serving/export.py) on the
CPU: JAX's four export tests (tests/unit/test_serving.py TestExportedServing)
on a narrow resnet18, the port's bundles against JAX's bundles on the same
weights (a narrow resnet18 on prepared 32² frames and a two-stage Swin on
raw frames, whose programs hold the kernels as `thyroid_tpu_torch::` ops),
an int8 bundle against the int8 engine, a bundle served in a process that
never imports the model code, and `serving/server.py --bundle` answering a
post from the resnet18 bundle. Each bundle is exported and loaded once per
module (a program's export and its deserialisation take seconds on the
CPU)."""
import collections
import json
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_server import npy, request
from tests.test_torch_serving import NARROW_RESNET, prepared_frames
from tests.torch_parity import SMALL_SWIN, jax_cnn, jax_swin
from tests.torch_parity import one_torch_thread  # noqa: F401
from thyroid_tpu_torch.serving import export_engine, load_exported
from thyroid_tpu_torch.serving import server as srv
from thyroid_tpu_torch.serving.engine import InferenceEngine

ROOT = Path(__file__).resolve().parents[1]
# kernels per forward of SMALL_SWIN (two stages of two blocks): one QKV
# LN + matmul per block and the merge's, one LN + MLP and one block
# attention per block, kernel 1 once
SWIN_OPS = {"percentile_normalize": 1, "ln_matmul": 5, "ln_mlp": 4,
            "swin_block_attention": 4}


@pytest.fixture(scope="module")
def resnet_variables():
    return jax_cnn(NARROW_RESNET)[1]


@pytest.fixture(scope="module")
def engine(resnet_variables):
    return InferenceEngine(NARROW_RESNET, variables=resnet_variables,
                           device="cpu", buckets=(1, 4), raw_inputs=False)


@pytest.fixture(scope="module")
def bundle(engine, tmp_path_factory):
    out = tmp_path_factory.mktemp("bundle")
    return out, export_engine(engine, str(out), buckets=(1, 4))


@pytest.fixture(scope="module")
def loaded(bundle):
    return load_exported(str(bundle[0]), device="cpu")


def graph_ops(program):
    """{op: calls} of the thyroid_tpu_torch ops in a loaded bucket program."""
    return collections.Counter(
        str(n.target).split(".")[1] for n in program.graph.nodes
        if n.op == "call_function" and str(n.target).startswith("thyroid_tpu_torch."))


@pytest.mark.unit
def test_export_roundtrip_matches_engine(engine, bundle, loaded):
    out, manifest = bundle
    assert manifest["buckets"] == [1, 4]
    assert manifest["format"] == "thyroid_tpu_torch.serving.export/v1"
    assert {a["file"] for a in manifest["artifacts"]} == {"bucket_1.pt2",
                                                          "bucket_4.pt2"}
    assert (out / "weights.pt").exists()
    x = prepared_frames(3, seed=0)
    got = loaded.predict(x)              # pads 3 → 4 with zeros, slices back
    assert got.shape == (3, 2)
    np.testing.assert_allclose(got, engine.predict(x), atol=1e-6, rtol=0)
    assert loaded.bucket_for(3) == 4 and loaded.bucket_for(9) == 4
    # the programs hold no weights: one weights file serves every bucket
    weights = torch.load(out / "weights.pt", weights_only=True)
    assert set(dict(engine.model.named_parameters())) <= set(weights)
    for program in loaded._fns.values():
        assert not dict(program.named_parameters())


@pytest.mark.unit
def test_exported_predict_chunks_large_requests(engine, loaded):
    x = prepared_frames(9, seed=1)
    got = loaded.predict(x)              # 9 > top bucket 4 → 4 + 4 + 1→4
    assert got.shape == (9, 2)
    np.testing.assert_allclose(got, engine.predict(x), atol=1e-6, rtol=0)


@pytest.mark.unit
def test_export_rejects_mesh_engines(tmp_path):
    """A real mesh engine (the CPU twice) is refused, as JAX's export
    refuses its mesh engines, before anything is written."""
    from thyroid_tpu_torch.parallel import create_mesh

    engine = InferenceEngine(NARROW_RESNET, device="cpu", buckets=(2,),
                             raw_inputs=False,
                             mesh=create_mesh({"data": 2}, devices=["cpu", "cpu"]))
    with pytest.raises(ValueError, match="mesh"):
        export_engine(engine, str(tmp_path / "b"))
    assert not (tmp_path / "b").exists()


@pytest.mark.unit
def test_load_rejects_non_bundle(tmp_path):
    (tmp_path / "manifest.json").write_text("{}")
    with pytest.raises(ValueError):
        load_exported(str(tmp_path), device="cpu")
    with pytest.raises(ValueError):
        load_exported(str(tmp_path / "absent"), device="cpu")


def jax_bundle_probs(engine, out: Path, frames):
    from thyroid_tpu.serving import export_engine as jax_export
    from thyroid_tpu.serving import load_exported as jax_load

    jax_export(engine, str(out), buckets=(4,), platforms=("cpu",))
    return jax_load(str(out)).predict(frames)


@pytest.mark.unit
def test_resnet_bundle_matches_jax_bundle(loaded, resnet_variables, tmp_path):
    """The port's bundle against JAX's cpu bundle of the same narrow
    resnet18 on prepared frames, within test_torch_serving's 1e-5."""
    from thyroid_tpu.serving import InferenceEngine as JaxEngine

    frames = prepared_frames(3, seed=2)
    want = jax_bundle_probs(
        JaxEngine(model_config=NARROW_RESNET, variables=resnet_variables,
                  buckets=(4,), raw_inputs=False), tmp_path, frames)
    got = loaded.predict(frames)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.ptp(want[:, 0]) > 1e-4


@pytest.fixture(scope="module")
def swin(tmp_path_factory):
    """(engine, bundle directory, loaded bundle, params) of a two-stage
    Swin on raw 512² frames, exported on the CPU with bucket 4."""
    params = jax_swin(SMALL_SWIN)[1]
    port = InferenceEngine(SMALL_SWIN, params=params, buckets=(4,),
                           device="cpu")
    out = tmp_path_factory.mktemp("swin")
    export_engine(port, str(out))
    return port, out, load_exported(str(out), device="cpu"), params


def raw_frames(n: int, seed: int) -> np.ndarray:
    return (np.random.RandomState(seed).rand(n, 512, 512, 1) * 65535) \
        .astype(np.float32)


@pytest.mark.unit
def test_swin_bundle_matches_jax_bundle(swin, tmp_path):
    """A two-stage Swin on raw 512² frames: the port's bundle, exported on
    the CPU, holds kernels 1-4 as ops at the counts its depth implies and
    agrees with JAX's bundle on the same weights within 1e-5."""
    from thyroid_tpu.serving import InferenceEngine as JaxEngine

    _, _, bundle, params = swin
    assert graph_ops(bundle._fns[4]) == SWIN_OPS
    frames = raw_frames(3, seed=3)
    want = jax_bundle_probs(
        JaxEngine(model_config=SMALL_SWIN, buckets=(4,),
                  variables={"params": params}), tmp_path, frames)
    got = bundle.predict(frames)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.ptp(want[:, 0]) > 1e-4


@pytest.mark.unit
def test_int8_bundle_matches_int8_engine(engine, resnet_variables, tmp_path):
    int8 = InferenceEngine(NARROW_RESNET, variables=resnet_variables,
                           device="cpu", buckets=(4,), raw_inputs=False,
                           quantize="int8")
    export_engine(int8, str(tmp_path))
    frames = prepared_frames(4, seed=4)
    got = load_exported(str(tmp_path), device="cpu").predict(frames)
    np.testing.assert_allclose(got, int8.predict(frames), atol=1e-6, rtol=0)
    # the int8 program ran: the float engine answers otherwise
    assert np.abs(got - engine.predict(frames)).max() > 0


@pytest.mark.unit
def test_bundle_serves_without_model_code(swin, tmp_path):
    """Loading the Swin bundle and predicting in a fresh process imports
    neither the models, the config tree, the engine nor JAX, and answers
    the engine's predict."""
    port, out, _, _ = swin
    x = raw_frames(2, seed=5)
    np.save(tmp_path / "x.npy", x)
    code = (
        "import json, sys, numpy as np\n"
        "from thyroid_tpu_torch.serving import load_exported\n"
        f"eng = load_exported({str(out)!r}, device='cpu')\n"
        f"p = eng.predict(np.load({str(tmp_path / 'x.npy')!r}))\n"
        "bad = [m for m in sys.modules if m.startswith(("
        "'thyroid_tpu_torch.models', 'thyroid_tpu_torch.config', "
        "'thyroid_tpu_torch.serving.engine', 'jax', 'thyroid_tpu.'))]\n"
        "print(json.dumps({'probs': p.tolist(), 'bad': bad}))\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    answer = json.loads(run.stdout.strip().splitlines()[-1])
    assert answer["bad"] == []
    np.testing.assert_allclose(answer["probs"], port.predict(x), atol=1e-6)


@pytest.mark.unit
def test_server_serves_a_bundle(engine, bundle, loaded):
    """`--bundle` serves the resnet18 bundle through the aggregator: its
    name is bundle:<model>, and a single-frame post answers the bundle's
    own predict and the engine's (6 decimals)."""
    server, served, agg = srv.build_server([
        "--bundle", str(bundle[0]), "--device", "cpu", "--port", "0",
        "--no-warmup", "--max-delay-ms", "1"])
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.server_address[1]
        code, health = request(port, "GET", "/healthz")
        assert (code, health["model"], health["buckets"]) == \
            (200, "bundle:resnet18", [1, 4])
        frame = prepared_frames(1, seed=23)
        code, body = request(port, "POST", "/predict", npy(frame[0, ..., 0]))
        assert code == 200 and agg.requests_served == 1
        np.testing.assert_allclose(body["probs"], served.predict(frame), atol=1e-6)
        np.testing.assert_allclose(body["probs"], loaded.predict(frame), atol=1e-6)
        np.testing.assert_allclose(body["probs"], engine.predict(frame), atol=1e-6)
    finally:
        server.shutdown()
        server.server_close()
        agg.close()
        thread.join(timeout=10)
