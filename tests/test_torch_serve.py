"""The port's HTTP model server (`dl4ds_tpu_torch.serve`) on port artifacts,
on the CPU: the cases of tests/test_serve.py (npy, JSON and npz over a
loopback HTTP server on an ephemeral port, healthz and meta, a bad body
answered 400, a pinned batch padded and chunked, a spatio-temporal
artifact's warmup, micro-batch merges, power-of-two device batches, bad
shapes isolated, eager merges), each output held against the network's own
eval forward; and the port's and the JAX package's micro-batch loops fed
the same queued requests, which must form the same groups, the overshoot of
max_batch included. The artifacts are built once, in a module fixture;
small sizes (n_filters 4, 8x8 grids)."""

import collections
import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from dl4ds_tpu import serve as jserve

import dl4ds_tpu_torch as tds
from dl4ds_tpu_torch.serve import ModelServer, make_http_server, _npy_bytes
from _torch_xla import quick_xla  # noqa: F401

ATOL = 1e-6


@pytest.fixture(autouse=True, scope='module')
def _torch_threads():
    torch.set_num_threads(2)


def _model(aux=False, recurrent=False):
    kw = dict(scale=4, n_channels=1, n_aux_channels=1 if aux else 0,
              lr_size=(8, 8), n_filters=4, n_blocks=1, attention=False)
    if recurrent:
        return tds.recnet_postupsampling('resnet', 'spc', time_window=3,
                                         **kw)
    return tds.net_postupsampling('resnet', 'spc', **kw)


@pytest.fixture(scope='module')
def artifacts(tmp_path_factory):
    """{name: (network, artifact dir)}: symbolic batch, symbolic batch
    with aux, batch pinned to 2, and a spatio-temporal model pinned to
    2."""
    root = tmp_path_factory.mktemp('serve')
    out = {}
    for name, model, batch in (('poly', _model(), 'poly'),
                               ('aux', _model(aux=True), 'poly'),
                               ('pinned', _model(), 2),
                               ('st', _model(recurrent=True), 2)):
        net = model.init(0, device='cpu')
        path = str(root / name)
        tds.save_serving_artifact(model, net, path, batch=batch)
        out[name] = (net, path)
    return out


def _direct(net, x, aux=None):
    with torch.no_grad():
        return net(torch.from_numpy(x), None if aux is None
                   else torch.from_numpy(aux)).numpy()


@pytest.fixture()
def served(artifacts):
    _, path = artifacts['poly']
    httpd, model = make_http_server(path, port=0)   # ephemeral port
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        yield f'http://127.0.0.1:{httpd.server_address[1]}', model
    finally:
        httpd.shutdown()
        th.join(timeout=5)


def _post(url, body, ctype):
    req = urllib.request.Request(url, data=body, method='POST',
                                 headers={'Content-Type': ctype})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.headers.get('Content-Type'), resp.read()


def test_http_predict_npy_roundtrip(served, artifacts, rng):
    base, model = served
    x = rng.standard_normal((3, 8, 8, 1)).astype('float32')
    ctype, raw = _post(base + '/predict', _npy_bytes(x), 'application/x-npy')
    assert ctype == 'application/x-npy'
    y = np.load(io.BytesIO(raw))
    assert y.shape == (3, 32, 32, 1)
    # byte-identical with the in-process ModelServer path
    np.testing.assert_array_equal(y, model.predict(x))
    np.testing.assert_allclose(y, _direct(artifacts['poly'][0], x),
                               atol=ATOL)


def test_http_predict_json(served, artifacts, rng):
    base, model = served
    x = rng.standard_normal((2, 8, 8, 1)).astype('float32')
    body = json.dumps({'data': x.tolist()}).encode()
    ctype, raw = _post(base + '/predict', body, 'application/json')
    assert ctype == 'application/json'
    out = json.loads(raw)
    assert out['shape'] == [2, 32, 32, 1]
    y = np.asarray(out['prediction'], np.float32)
    np.testing.assert_array_equal(y, model.predict(x))


def test_http_healthz_and_meta(served):
    base, _ = served
    with urllib.request.urlopen(base + '/healthz', timeout=30) as resp:
        h = json.loads(resp.read())
    assert h['status'] == 'ok' and h['requests'] >= 0
    assert h['model'] == 'resnet_spc' and h['quantize'] is None
    with urllib.request.urlopen(base + '/meta', timeout=30) as resp:
        meta = json.loads(resp.read())
    assert meta['batch'] == 'poly' and meta['platforms'] == ['cpu']
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(base + '/nowhere', timeout=30)
    assert err.value.code == 404


@pytest.mark.parametrize('body,ctype', [
    (b'not an npy', 'application/x-npy'),
    (b'{"data": [[1, 2', 'application/json'),
    (b'not an npz', 'application/x-npz')])
def test_http_bad_body_is_400_not_crash(served, body, ctype):
    base, _ = served
    req = urllib.request.Request(base + '/predict', data=body, method='POST',
                                 headers={'Content-Type': ctype})
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(req, timeout=30)
    assert err.value.code == 400
    assert 'error' in json.loads(err.value.read())


def test_a_burst_of_connections_is_queued_not_dropped(artifacts):
    """Connections opened while the server accepts none all complete at
    once: the kernel queues LISTEN_BACKLOG of them. With socketserver's
    default backlog of 5 it drops the SYNs past the queue, and their
    clients wait out TCP's one-second retransmission (phase 19's p99)."""
    import socket
    _, path = artifacts['poly']
    httpd, _ = make_http_server(path, port=0, warmup=False)
    socks = []
    try:
        t0 = time.perf_counter()
        for _ in range(24):
            socks.append(socket.create_connection(httpd.server_address,
                                                  timeout=10))
        assert time.perf_counter() - t0 < 0.9
    finally:
        for sock in socks:
            sock.close()
        httpd.server_close()


def test_pinned_batch_pads_and_chunks(artifacts, rng):
    """A batch-pinned artifact serves any request size: 5 samples through a
    batch-2 artifact are 3 chunks, the last one padded."""
    net, path = artifacts['pinned']
    srv = ModelServer(path)
    calls = []
    inner = srv.call
    srv.call = lambda x, aux=None: (calls.append(len(x)), inner(x, aux))[1]
    x = rng.standard_normal((5, 8, 8, 1)).astype('float32')
    y = srv.predict(x)
    assert y.shape == (5, 32, 32, 1) and calls == [2, 2, 2]
    np.testing.assert_allclose(y, _direct(net, x), atol=ATOL)
    assert srv.health()['device_batches'] == 1


def test_npz_with_aux(artifacts, rng):
    """A model with an HR-aux branch serves through the npz encoding."""
    net, path = artifacts['aux']
    httpd, srv = make_http_server(path, port=0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        x = rng.standard_normal((2, 8, 8, 1)).astype('float32')
        aux = rng.standard_normal(
            (2,) + tuple(srv.meta['aux_shape'])).astype('float32')
        buf = io.BytesIO()
        np.savez(buf, data=x, aux=aux)
        _, raw = _post(f'http://127.0.0.1:{httpd.server_address[1]}'
                       f'/predict', buf.getvalue(), 'application/x-npz')
        y = np.load(io.BytesIO(raw))
        assert y.shape == (2, 32, 32, 1)
        np.testing.assert_allclose(y, _direct(net, x, aux), atol=ATOL)
        # one aux grid for the whole request is broadcast to its samples
        y1 = srv.predict(x, aux[0])
        np.testing.assert_allclose(
            y1, _direct(net, x, np.repeat(aux[:1], 2, 0)), atol=ATOL)
    finally:
        httpd.shutdown()
        th.join(timeout=5)


def test_spatiotemporal_artifact_warmup_and_predict(artifacts, rng):
    """A spatio-temporal artifact serves end to end: the warmup takes the
    whole per-sample shape (T, H, W, C), and a batch-pinned one pads and
    chunks as a spatial one does."""
    net, path = artifacts['st']
    srv = ModelServer(path)          # warmup=True: runs at startup
    assert tuple(srv.meta['input_shape']) == (3, 8, 8, 1)
    x = rng.standard_normal((3, 3, 8, 8, 1)).astype('float32')
    y = srv.predict(x)               # 3 samples through a batch-2 artifact
    assert y.shape == (3, 3, 32, 32, 1)
    np.testing.assert_allclose(y, _direct(net, x), atol=ATOL)


def _concurrent(srv, xs):
    results = [None] * len(xs)
    start = threading.Barrier(len(xs))

    def worker(i):
        start.wait()
        results[i] = srv.predict(xs[i])

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(xs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert all(r is not None for r in results)
    return results


def test_dynamic_microbatching_merges_concurrent_requests(artifacts, rng):
    """With batch_window_ms > 0 concurrent same-shape requests merge into
    fewer device calls, and every caller gets its own slice."""
    net, path = artifacts['poly']
    srv = ModelServer(path, batch_window_ms=100, max_batch=16)
    xs = [rng.standard_normal((1, 8, 8, 1)).astype('float32')
          for _ in range(6)]
    results = _concurrent(srv, xs)
    for x, y in zip(xs, results):
        np.testing.assert_allclose(y, _direct(net, x), atol=ATOL)
    assert srv.n_device_batches < 6, srv.n_device_batches
    assert srv.health()['requests'] == 6
    assert srv.health()['samples'] == 6


def test_pow2_padding_bounds_symbolic_batch_shapes(artifacts, rng):
    """Micro-batched symbolic-batch serving pads each merged device call up
    to the next power of two, and warmup runs every padded size; padding
    is invisible to callers and counters."""
    net, path = artifacts['poly']
    warm = []
    real = ModelServer._host
    try:
        ModelServer._host = lambda self, x, aux: (warm.append(len(x)),
                                                  real(self, x, aux))[1]
        srv = ModelServer(path, batch_window_ms=50, max_batch=12)
    finally:
        ModelServer._host = real
    assert warm == [1, 2, 4, 8, 16]
    assert srv.health()['pad_pow2'] is True
    sizes = []
    inner = srv.call
    srv.call = lambda x, aux=None: (sizes.append(len(x)), inner(x, aux))[1]
    x = rng.standard_normal((3, 8, 8, 1)).astype('float32')
    y = srv.predict(x)
    assert sizes == [4]                       # 3 -> padded to 4
    np.testing.assert_allclose(y, _direct(net, x), atol=ATOL)
    assert srv.health()['samples'] == 3       # request samples, not padded
    assert srv.predict(x[:1]).shape == (1, 32, 32, 1) and sizes[-1] == 1
    srv2 = ModelServer(path, batch_window_ms=50, max_batch=16,
                       pad_pow2=False)
    assert srv2.health()['pad_pow2'] is False
    np.testing.assert_allclose(srv2.predict(x), y, atol=ATOL)


def test_dynamic_microbatching_isolates_bad_shapes(artifacts, rng):
    """Requests of another shape are grouped apart, so a bad request fails
    alone, with its own error, and the valid ones around it are served."""
    _, path = artifacts['poly']
    srv = ModelServer(path, batch_window_ms=40, max_batch=16)
    good = rng.standard_normal((1, 8, 8, 1)).astype('float32')
    bad = rng.standard_normal((2, 16, 16, 1)).astype('float32')
    out, errs = {}, {}

    def worker(name, x):
        try:
            out[name] = srv.predict(x)
        except Exception as exc:
            errs[name] = exc

    ts = [threading.Thread(target=worker, args=('good', good)),
          threading.Thread(target=worker, args=('bad', bad)),
          threading.Thread(target=worker, args=('good2', good))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert out['good'].shape == (1, 32, 32, 1)
    assert out['good2'].shape == (1, 32, 32, 1)
    assert 'bad' in errs and 'bad' not in out


def test_eager_microbatching_merges_without_window_waits(artifacts, rng):
    """eager=True: a lone request goes at once instead of waiting out the
    window, and requests that arrive while the device is busy still
    merge."""
    net, path = artifacts['poly']
    srv = ModelServer(path, batch_window_ms=2000, max_batch=16, eager=True)
    assert srv.health()['eager'] is True
    x0 = rng.standard_normal((1, 8, 8, 1)).astype('float32')
    t0 = time.perf_counter()
    y0 = srv.predict(x0)
    assert time.perf_counter() - t0 < 1.5, \
        'the eager batcher waited out the window on an idle queue'
    np.testing.assert_allclose(y0, _direct(net, x0), atol=ATOL)
    xs = [rng.standard_normal((1, 8, 8, 1)).astype('float32')
          for _ in range(8)]
    base = srv.n_device_batches
    results = _concurrent(srv, xs)
    for x, y in zip(xs, results):
        np.testing.assert_allclose(y, _direct(net, x), atol=ATOL)
    assert srv.n_device_batches - base < 8


def _bare(cls, max_batch, eager, window_ms):
    """A server of `cls` without an artifact, its batcher not started and
    its device call recording each group's sample tags."""
    srv = cls.__new__(cls)
    srv.batch, srv.pad_pow2 = 'poly', False
    srv.lock = threading.Lock()
    srv.n_requests = srv.n_samples = srv.n_device_batches = 0
    srv.batch_window_ms, srv.max_batch, srv.eager = window_ms, max_batch, eager
    srv._queue, srv._queue_cv = collections.deque(), threading.Condition()
    groups = []

    def run(data, aux):
        groups.append([int(v) for v in data.reshape(len(data), -1)[:, 0]])
        return data
    srv._run = run
    return srv, groups


# (samples, per-sample shape, with aux) of the queued requests
_QUEUE = [(3, (8, 8, 1), False), (2, (8, 8, 1), False), (2, (8, 8, 1), False),
          (1, (4, 4, 1), False), (1, (4, 4, 1), False), (4, (8, 8, 1), True),
          (1, (8, 8, 1), True), (1, (8, 8, 1), False), (5, (8, 8, 1), False),
          (1, (8, 8, 1), False), (1, (8, 8, 1), False), (1, (8, 8, 1), False),
          (2, (8, 8, 1), False)]


@pytest.mark.parametrize('eager', [True, False])
def test_merge_groups_equal_the_jax_servers(eager):
    """The same queued requests, fed to the port's and to the JAX
    package's micro-batch loop, form the same groups: a group takes the
    queued requests of its first request's shape key in order, while it
    holds fewer than max_batch samples, so its last request may carry it
    past max_batch (here 3 + 2 = 5 > 4)."""
    found = []
    for cls in (ModelServer, jserve.ModelServer):
        # a window far longer than forming a group takes, so that the
        # groups do not depend on the host's speed
        srv, groups = _bare(cls, max_batch=4, eager=eager, window_ms=1000)
        tag, items = 0, []
        for n, shape, with_aux in _QUEUE:
            data = np.arange(tag, tag + n, dtype=np.float32)[:, None, None,
                                                              None]
            data = np.broadcast_to(data, (n, *shape)).copy()
            aux = np.zeros((n, 2, 2, 1), np.float32) if with_aux else None
            items.append({'data': data, 'aux': aux,
                          'done': threading.Event(), 'result': None,
                          'error': None})
            tag += n
        srv._queue.extend(items)
        threading.Thread(target=srv._batch_loop, daemon=True).start()
        for item in items:
            assert item['done'].wait(timeout=30)
            assert item['error'] is None
        found.append(groups)
    port, jax_groups = found
    assert port == jax_groups
    assert port[0] == [0, 1, 2, 3, 4]          # past max_batch
    assert max(len(g) for g in port) > 4
