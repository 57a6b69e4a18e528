"""The port's BatchAggregator and HTTP front end
(thyroid_tpu_torch/serving/{engine,server}.py) on the CPU: the three
aggregator behaviours of JAX's tests (tests/unit/test_serving.py), and the
server on loopback against the engine it serves and JAX's engine."""
import http.client
import io
import json
import threading

import numpy as np
import pytest

from tests.test_torch_serving import NARROW_RESNET, prepared_frames, save_port_checkpoint
from tests.torch_parity import jax_cnn, one_torch_thread  # noqa: F401
from thyroid_tpu_torch.serving import server as srv
from thyroid_tpu_torch.serving.engine import BatchAggregator, InferenceEngine


@pytest.fixture(scope="module")
def variables():
    return jax_cnn(NARROW_RESNET)[1]


@pytest.fixture(scope="module")
def engine(variables):
    return InferenceEngine(NARROW_RESNET, variables=variables, device="cpu",
                           buckets=(1, 4, 8), raw_inputs=False)


@pytest.mark.unit
def test_aggregator_coalesces_concurrent_requests(engine):
    """8 concurrent submits against max_batch 8 take at most 4 batches;
    each answer equals the engine's on the whole stack within 1e-6."""
    agg = BatchAggregator(engine, max_batch=8, max_delay_ms=50.0)
    imgs = list(prepared_frames(8, seed=3))
    results = [None] * 8

    def worker(i):
        results[i] = agg.submit(imgs[i])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    agg.close()
    assert not any(t.is_alive() for t in threads)
    direct = engine.predict(np.stack(imgs))
    for i in range(8):
        np.testing.assert_allclose(results[i], direct[i], atol=1e-6)
    assert agg.batches_dispatched <= 4
    assert agg.requests_served == 8


@pytest.mark.unit
def test_aggregator_under_thread_stress(engine):
    """32 threads (more than the cores) submit 2 frames each with a
    shortened switch interval: every submit gets its own frame's answer
    (the engine's on that frame alone within 1e-5: the float32 model's
    rows do not depend on their neighbours beyond rounding), and every
    request is counted once."""
    import sys

    frames = prepared_frames(64, seed=24)
    want = engine.predict(frames)
    got = [None] * 64
    agg = BatchAggregator(engine, max_batch=8, max_delay_ms=1.0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def worker(k):
            for i in (2 * k, 2 * k + 1):
                got[i] = agg.submit(frames[i])

        threads = [threading.Thread(target=worker, args=(k,)) for k in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
        agg.close()
    assert not any(t.is_alive() for t in threads)
    assert agg.requests_served == 64
    np.testing.assert_allclose(np.stack(got), want, atol=1e-5)


@pytest.mark.unit
def test_bad_request_does_not_kill_the_worker(engine, monkeypatch):
    """A request of the wrong shape raises in its caller; a batch whose
    forward fails raises in its own callers; the aggregator lives on."""
    agg = BatchAggregator(engine, max_batch=8, max_delay_ms=5.0)
    good = prepared_frames(1, seed=6)[0]
    with pytest.raises(ValueError):
        agg.submit(np.zeros((2, 32, 32, 1), np.float32))      # not one image
    agg.submit(good)                                          # sets the shape
    with pytest.raises(ValueError):
        agg.submit(np.zeros((16, 16, 1), np.float32))         # mismatch
    predict = engine.predict

    def fail_once(images):
        monkeypatch.setattr(engine, "predict", predict)
        raise RuntimeError("forward failed")

    monkeypatch.setattr(engine, "predict", fail_once)
    with pytest.raises(RuntimeError, match="batched inference failed"):
        agg.submit(good)
    probs = agg.submit(good)                                  # still alive
    agg.close()
    assert probs.shape == (2,) and agg.requests_served == 2


@pytest.mark.unit
def test_delay_dispatch_single_request(engine):
    """A lone request goes out after max_delay_ms, in a batch of its own."""
    agg = BatchAggregator(engine, max_batch=8, max_delay_ms=5.0)
    img = prepared_frames(1, seed=4)[0]
    probs = agg.submit(img)
    agg.close()
    assert probs.shape == (2,) and agg.batches_dispatched == 1
    np.testing.assert_allclose(probs.sum(), 1.0, atol=1e-5)
    np.testing.assert_allclose(probs, engine.predict(img[None])[0], atol=1e-6)


@pytest.fixture(scope="module")
def served(variables, tmp_path_factory):
    """`python -m thyroid_tpu_torch.serving.server` on a port checkpoint of
    the narrow resnet18, on the CPU at 127.0.0.1 and a free port, serving
    in a thread: (port, engine, aggregator)."""
    ck = save_port_checkpoint(tmp_path_factory.mktemp("serve") / "ck",
                              NARROW_RESNET, variables)
    server, eng, agg = srv.build_server([
        "--checkpoint", str(ck), "--device", "cpu", "--port", "0",
        "--preprocessed", "--buckets", "1", "4", "--max-delay-ms", "5"])
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield server.server_address[1], eng, agg
    server.shutdown()
    server.server_close()
    agg.close()
    thread.join(timeout=10)


def request(port, method, path, body=None, ctype="application/octet-stream"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request(method, path, body=body, headers={"Content-Type": ctype})
    resp = conn.getresponse()
    out = resp.status, json.loads(resp.read())
    conn.close()
    return out


def npy(arr) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


@pytest.mark.unit
def test_server_health_and_paths(served):
    port, eng, _ = served
    code, body = request(port, "GET", "/healthz")
    assert code == 200 and body["status"] == "ok" and body["buckets"] == [1, 4]
    assert body["model"].endswith("ck")
    assert request(port, "GET", "/nope")[0] == 404
    assert request(port, "POST", "/other", npy(prepared_frames(2)))[0] == 404


@pytest.mark.unit
def test_server_predicts_npy_and_json(served, variables):
    """A 3-frame .npy body and a 2-frame JSON body: the engine's
    probabilities (rounded to 6 decimals by the server, atol 1e-6), JAX's
    engine's on the same weights within 1e-5, argmax as `pred`."""
    from thyroid_tpu.serving import InferenceEngine as JaxEngine

    port, eng, _ = served
    frames = prepared_frames(3, seed=21)
    code, body = request(port, "POST", "/predict", npy(frames))
    assert code == 200
    probs = np.asarray(body["probs"])
    np.testing.assert_allclose(probs, eng.predict(frames), atol=1e-6)
    want = JaxEngine(model_config=NARROW_RESNET, variables=variables,
                     buckets=(4,), raw_inputs=False).predict(frames)
    np.testing.assert_allclose(probs, want, atol=1e-5)
    assert body["pred"] == probs.argmax(-1).tolist()
    code, body = request(port, "POST", "/predict",
                         json.dumps({"images": frames[:2, ..., 0].tolist()}),
                         ctype="application/json")
    assert code == 200
    np.testing.assert_allclose(body["probs"], eng.predict(frames[:2]), atol=1e-6)


@pytest.mark.unit
def test_server_coalesces_single_frames(served):
    """Single-frame posts go through the aggregator; 400 with the error's
    text on a body that is not an array."""
    port, eng, agg = served
    before = agg.requests_served
    frame = prepared_frames(1, seed=22)
    code, body = request(port, "POST", "/predict", npy(frame[0, ..., 0]))
    assert code == 200 and agg.requests_served == before + 1
    np.testing.assert_allclose(body["probs"], eng.predict(frame), atol=1e-6)
    code, body = request(port, "POST", "/predict", b"not an array")
    assert code == 400 and body["error"].startswith(("ValueError", "UnpicklingError"))


@pytest.mark.unit
def test_server_coalesces_concurrent_posts(served):
    """16 concurrent single-frame posts (more than socketserver's default
    listen backlog of 5, past which connects are dropped and retried after
    1 s) all answer, in fewer batches than posts, each its batch's row."""
    port, eng, agg = served
    assert srv.Server.request_queue_size >= 16
    frames = prepared_frames(16, seed=23)
    out = [None] * 16
    seen = []
    predict = eng.predict

    def recorded(images):
        probs = predict(images)
        seen.append((images, probs))
        return probs

    eng.predict = recorded
    before = agg.batches_dispatched

    def client(i):
        out[i] = request(port, "POST", "/predict", npy(frames[i, ..., 0]))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(16)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        eng.predict = predict
    assert not any(t.is_alive() for t in threads)
    assert agg.batches_dispatched - before == len(seen) < 16
    for i, (code, body) in enumerate(out):
        row = [p[j] for im, p in seen for j in range(len(im))
               if np.array_equal(im[j], frames[i])]
        assert code == 200 and len(row) == 1
        np.testing.assert_allclose(body["probs"][0], row[0], atol=1e-6)


@pytest.mark.unit
@pytest.mark.parametrize("argv,item", [
    (["--bundle", "exported/", "--model", "resnet18"], "--bundle is exclusive"),
    (["--model", "resnet18", "--data-parallel", "2"], "Parallelism")])
def test_server_refusals(argv, item, capsys):
    """A bundle with a model is refused with JAX's usage error
    (SystemExit); data-parallel serving, once refused here naming
    Parallelism, builds: --data-parallel 2 on the CPU serves from two
    replica shards, buckets rounded up to multiples of 2, the start line
    naming them (tests/test_torch_parallel.py answers a post through
    it)."""
    if item == "Parallelism":
        server, engine, aggregator = srv.build_server(
            argv + ["--device", "cpu", "--port", "0", "--no-warmup",
                    "--img-size", "32", "--buckets", "1", "3"])
        try:
            assert [str(d) for d in engine.shard_devices] == ["cpu", "cpu"]
            assert engine.buckets == (2, 4)
            assert "on ['cpu', 'cpu']" in capsys.readouterr().out
        finally:
            aggregator.close()
            server.server_close()
        return
    with pytest.raises(SystemExit) as err:
        srv.build_server(argv + ["--device", "cpu"])
    assert item in str(err.value) + capsys.readouterr().err


@pytest.mark.unit
@pytest.mark.parametrize("extra", [["--checkpoint", "ck"], ["--model", "resnet18"],
                                   ["--quantize", "int8"], ["--data-parallel", "2"]])
def test_bundle_is_exclusive(extra, capsys):
    """--bundle with any of --checkpoint, --model, --quantize or
    --data-parallel exits with JAX's usage error, before anything loads."""
    with pytest.raises(SystemExit) as err:
        srv.build_server(["--bundle", "absent/", "--device", "cpu"] + extra)
    assert err.value.code == 2
    assert ("--bundle is exclusive with --checkpoint/--model/--quantize/"
            "--data-parallel") in capsys.readouterr().err


@pytest.mark.unit
def test_server_arguments():
    """The script's arguments, plus --device."""
    args = srv.parser().parse_args(["--model", "swin_tiny", "--quantize", "int8",
                                    "--device", "cpu", "--quality"])
    assert (args.model, args.quantize, args.device, args.quality) == \
        ("swin_tiny", "int8", "cpu", True)
    assert args.buckets == [1, 8, 32, 128] and args.max_delay_ms == 10.0
    with pytest.raises(SystemExit):
        srv.parser().parse_args(["--quantize", "fp8"])
