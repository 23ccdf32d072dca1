"""Minimal HTTP server for frozen serving artifacts (the counterpart of
`dl4ds_tpu/serve.py`).

`export.save_serving_artifact` freezes a network's forward, weights and
kernels included, into `forward.pt2`; this module serves that artifact
over HTTP with nothing beyond the Python standard library, numpy and
torch:

    python -m dl4ds_tpu_torch.serve --artifact /path/to/artifact --port 8000

Endpoints
---------
- ``GET /healthz``: liveness and request counters (JSON).
- ``GET /meta``: the artifact's ``serving_meta.json``.
- ``POST /predict``: run the frozen forward. Three body encodings:
    * ``application/x-npy``: one ``.npy`` array (the model input batch);
      the response is the ``.npy`` bytes of the prediction.
    * ``application/x-npz``: an ``np.savez`` archive with array ``data``
      and, for models with an HR-aux branch, ``aux``; the response is npy.
    * ``application/json``: ``{"data": nested-list[, "aux": ...]}``; the
      response is JSON ``{"prediction": nested-list, "shape": [...]}``.
  A body that cannot be read or run gets 400 with ``{"error": ...}``.

Batching, as in the JAX package: an artifact with a symbolic batch
(``batch='poly'``, the default) takes any request batch, and under dynamic
micro-batching the merged device calls are padded up to the next power of
two (``pad_pow2``), so that the calls take at most log2(max_batch) + 1
shapes, which warmup runs first. A batch-pinned artifact is padded and
chunked to its batch, so clients never see the constraint. Device work runs
under a lock (one card, one program at a time), and each device batch's
output is copied to the host once, in float32 (a bfloat16 model's values
held exactly); IO threads overlap through ThreadingHTTPServer.
"""

import argparse
import collections
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

__all__ = ['ModelServer', 'make_http_server', 'serve_forever', 'main']

# connections the kernel queues while the server accepts none
LISTEN_BACKLOG = 128


class ModelServer:
    """Loads a serving artifact and answers prediction requests.

    Independent of the HTTP layer: `predict(data, aux=None)` takes and
    returns numpy arrays and can back any transport. `device` (None: the
    artifact's own) is where the artifact runs (`load_serving_artifact`).
    """

    def __init__(self, artifact_dir, warmup=True, batch_window_ms=0,
                 max_batch=64, pad_pow2=None, eager=False, device=None):
        from .export import load_serving_artifact
        self.call, self.meta = load_serving_artifact(artifact_dir, device)
        self.artifact_dir = artifact_dir
        self.batch = self.meta.get('batch')
        # micro-batched merges vary in size request to request; padding the
        # device calls up to the next power of two bounds the shapes the
        # program meets to log2(max_batch) + 1, for <= 2x padded compute.
        # Default: on exactly when micro-batching is.
        self.pad_pow2 = (batch_window_ms > 0 if pad_pow2 is None
                         else bool(pad_pow2))
        self.lock = threading.Lock()
        self.started = time.time()
        self.n_requests = 0
        self.n_samples = 0
        self.n_device_batches = 0
        # dynamic micro-batching: with batch_window_ms > 0 concurrent
        # requests merge into one device call (collected for up to the window
        # after the first arrival, while fewer than max_batch samples are
        # held). eager=True never waits out the window on an empty queue:
        # merges form from the requests that queued while the previous
        # device call ran (the one dispatcher thread is the only device
        # user), so light load pays no window latency.
        self.batch_window_ms = batch_window_ms
        self.max_batch = max_batch
        self.eager = eager
        self._queue = collections.deque()
        self._queue_cv = threading.Condition()
        self._batcher = None
        if batch_window_ms > 0:
            self._batcher = threading.Thread(target=self._batch_loop,
                                             daemon=True)
            self._batcher.start()
        if warmup:
            self._warmup()

    # -- core ------------------------------------------------------------
    def _warmup(self):
        """Run the program once before the first request lands (the
        kernels' libraries load and their launch limits are queried then);
        with pow2 padding on, once at every padded size, 1, 2, 4, ... up to
        the next power of two at or above max_batch."""
        if isinstance(self.batch, int):
            sizes = [self.batch]
        elif self.pad_pow2:
            sizes = [1 << i
                     for i in range((self.max_batch - 1).bit_length() + 1)]
        else:
            sizes = [1]
        for b in sizes:
            # input_shape is the whole per-sample shape: (H, W, C), or
            # (T, H, W, C) for a spatio-temporal model
            x = np.zeros([b] + list(self.meta['input_shape']), 'float32')
            aux = None
            if self.meta.get('aux_shape') is not None:
                aux = np.zeros([b] + list(self.meta['aux_shape']),
                               'float32')
            self._host(x, aux)

    def _host(self, x, aux):
        """The program on one device batch, copied to the host once."""
        return self.call(x, aux).float().cpu().numpy()

    def predict(self, data, aux=None):
        """Run the frozen forward on a [N, H, W, C] (or model-rank) batch.

        Pads and chunks to the artifact's pinned batch when it has one; a
        symbolic-batch artifact runs the request in one call. With
        `batch_window_ms > 0`, concurrent requests of one sample shape are
        merged into one device call (the same results: the batch axis is
        independent).
        """
        data = np.asarray(data, 'float32')
        if len(data) == 0:
            raise ValueError('empty batch')
        if aux is not None:
            aux = np.asarray(aux, 'float32')
            if aux.ndim == len(self.meta['aux_shape']):
                aux = np.broadcast_to(aux[None], (len(data),) + aux.shape)
        if self._batcher is not None:
            return self._predict_batched(data, aux)
        with self.lock:
            self.n_requests += 1
            self.n_samples += len(data)
            return self._run(data, aux)

    def _run(self, data, aux):
        """One merged batch through the device (the caller holds the
        lock)."""
        self.n_device_batches += 1
        if not isinstance(self.batch, int):
            n = len(data)
            pad = ((1 << (n - 1).bit_length()) - n if self.pad_pow2 else 0)
            if pad:
                data = np.concatenate([data, np.repeat(data[-1:], pad, 0)])
                if aux is not None:
                    aux = np.concatenate([aux, np.repeat(aux[-1:], pad, 0)])
            y = self._host(data, aux)
            return y[:n] if pad else y
        bs = self.batch
        outs = []
        for i in range(0, len(data), bs):
            xb = data[i:i + bs]
            ab = aux[i:i + bs] if aux is not None else None
            pad = bs - len(xb)
            if pad:
                xb = np.concatenate([xb, np.repeat(xb[-1:], pad, 0)])
                if ab is not None:
                    ab = np.concatenate([ab, np.repeat(ab[-1:], pad, 0)])
            yb = self._host(xb, ab)
            outs.append(yb[:bs - pad] if pad else yb)
        return np.concatenate(outs)

    # -- dynamic micro-batching -------------------------------------------
    def _predict_batched(self, data, aux):
        item = {'data': data, 'aux': aux, 'done': threading.Event(),
                'result': None, 'error': None}
        with self._queue_cv:
            self._queue.append(item)
            self._queue_cv.notify()
        item['done'].wait()
        if item['error'] is not None:
            raise item['error']
        return item['result']

    @staticmethod
    def _shape_key(item):
        aux = item['aux']
        return (item['data'].shape[1:], aux is None,
                None if aux is None else aux.shape[1:])

    def _batch_loop(self):
        while True:
            with self._queue_cv:
                while not self._queue:
                    self._queue_cv.wait()
                first = self._queue.popleft()
            group = self._collect(first)
            try:
                data = (group[0]['data'] if len(group) == 1 else
                        np.concatenate([g['data'] for g in group]))
                aux = (group[0]['aux'] if group[0]['aux'] is None
                       or len(group) == 1 else
                       np.concatenate([g['aux'] for g in group]))
                with self.lock:
                    self.n_requests += len(group)
                    self.n_samples += len(data)
                    y = self._run(data, aux)
                off = 0
                for g in group:
                    g['result'] = y[off:off + len(g['data'])]
                    off += len(g['data'])
            except Exception as exc:
                for g in group:
                    g['error'] = exc
            finally:
                for g in group:
                    g['done'].set()

    def _collect(self, first):
        """The group that `first` opens: the queued requests of its shape
        key taken in order, for up to the window after it was taken, while
        the group holds fewer than max_batch samples. As in the JAX
        package, a request is taken whole, so the last one taken may carry
        the group past max_batch; a request of another shape ends the
        group and opens the next."""
        deadline = time.time() + self.batch_window_ms / 1000.0
        group = [first]
        n = len(first['data'])
        key = self._shape_key(first)
        while n < self.max_batch:
            remaining = deadline - time.time()
            if remaining <= 0:
                break
            with self._queue_cv:
                if not self._queue:
                    if self.eager:
                        break   # adaptive: the device is idle, go now
                    self._queue_cv.wait(timeout=remaining)
                if not self._queue:
                    break
                nxt = self._queue[0]
                if self._shape_key(nxt) != key:
                    break
                self._queue.popleft()
            group.append(nxt)
            n += len(nxt['data'])
        return group

    def health(self):
        return {
            'status': 'ok',
            'artifact': self.artifact_dir,
            'model': self.meta.get('name'),
            'batch': self.batch,
            'quantize': self.meta.get('quantize'),
            'uptime_s': round(time.time() - self.started, 1),
            'requests': self.n_requests,
            'samples': self.n_samples,
            'device_batches': self.n_device_batches,
            'batch_window_ms': self.batch_window_ms,
            'pad_pow2': self.pad_pow2,
            'eager': self.eager,
        }


def _parse_body(body, ctype):
    """Request body -> (data, aux, json_mode)."""
    if ctype.startswith('application/json'):
        payload = json.loads(body.decode())
        data = np.asarray(payload['data'], 'float32')
        aux = payload.get('aux')
        return data, (np.asarray(aux, 'float32')
                      if aux is not None else None), True
    if ctype.startswith('application/x-npz'):
        with np.load(io.BytesIO(body)) as z:
            if 'data' not in z:
                raise ValueError("npz body must contain array 'data'")
            return z['data'], (z['aux'] if 'aux' in z else None), False
    # default: a single .npy array
    return np.load(io.BytesIO(body), allow_pickle=False), None, False


def _npy_bytes(arr):
    buf = io.BytesIO()
    np.save(buf, np.asarray(arr, 'float32'), allow_pickle=False)
    return buf.getvalue()


def _make_handler(server):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, payload, ctype):
            self.send_response(code)
            self.send_header('Content-Type', ctype)
            self.send_header('Content-Length', str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def _send_json(self, code, obj):
            self._send(code, json.dumps(obj).encode(), 'application/json')

        def do_GET(self):
            if self.path == '/healthz':
                return self._send_json(200, server.health())
            if self.path == '/meta':
                return self._send_json(200, server.meta)
            return self._send_json(404, {'error': f'no route {self.path}'})

        def do_POST(self):
            if self.path != '/predict':
                return self._send_json(404,
                                       {'error': f'no route {self.path}'})
            try:
                n = int(self.headers.get('Content-Length', 0))
                body = self.rfile.read(n)
                ctype = self.headers.get('Content-Type',
                                         'application/x-npy')
                data, aux, json_mode = _parse_body(body, ctype)
                y = server.predict(data, aux=aux)
            except Exception as exc:  # the cause goes back to the client
                return self._send_json(400,
                                       {'error': f'{type(exc).__name__}: '
                                                 f'{exc}'})
            if json_mode:
                return self._send_json(200, {
                    'prediction': y.tolist(), 'shape': list(y.shape)})
            return self._send(200, _npy_bytes(y), 'application/x-npy')

        def log_message(self, fmt, *args):  # quiet by default
            pass

    return Handler


class _HTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer listening with a backlog of LISTEN_BACKLOG.
    socketserver's default of 5 (which the JAX package's server keeps)
    lets the kernel drop the connections of a burst of more clients, which
    then wait out TCP's one-second SYN retransmission: on an H100's host, 8
    clients on 127.0.0.1 saw a p99 of 1.1-1.4 s against a p50 of 96-169 ms
    (chip_smoke.py phase 19)."""
    request_queue_size = LISTEN_BACKLOG


def make_http_server(artifact_dir, host='127.0.0.1', port=8000,
                     warmup=True, batch_window_ms=0, max_batch=64,
                     pad_pow2=None, eager=False, device=None):
    """(ThreadingHTTPServer, ModelServer), not started: a caller drives the
    returned server, on an ephemeral port with port=0."""
    model = ModelServer(artifact_dir, warmup=warmup,
                        batch_window_ms=batch_window_ms,
                        max_batch=max_batch, pad_pow2=pad_pow2,
                        eager=eager, device=device)
    httpd = _HTTPServer((host, port), _make_handler(model))
    return httpd, model


def serve_forever(artifact_dir, host='0.0.0.0', port=8000,
                  batch_window_ms=0, max_batch=64, pad_pow2=None,
                  eager=False, device=None):
    httpd, model = make_http_server(artifact_dir, host=host, port=port,
                                    batch_window_ms=batch_window_ms,
                                    max_batch=max_batch, pad_pow2=pad_pow2,
                                    eager=eager, device=device)
    print(f'dl4ds_tpu_torch.serve: {model.meta.get("name")} on '
          f'http://{host}:{port} (batch={model.batch})', flush=True)
    httpd.serve_forever()


def main(argv=None):
    ap = argparse.ArgumentParser(
        description='Serve a dl4ds_tpu_torch frozen artifact over HTTP')
    ap.add_argument('--artifact', required=True,
                    help='directory written by save_serving_artifact')
    ap.add_argument('--host', default='0.0.0.0')
    ap.add_argument('--port', type=int, default=8000)
    ap.add_argument('--batch-window-ms', type=float, default=0,
                    help='dynamic micro-batching: merge concurrent '
                         'requests arriving within this window into one '
                         'device call (0 = off)')
    ap.add_argument('--max-batch', type=int, default=64,
                    help='sample cap per merged device call')
    ap.add_argument('--eager-batch', action='store_true',
                    help='adaptive micro-batching: never wait out the '
                         'window when the queue is empty; merge only the '
                         'requests that queued while the previous device '
                         'call ran (light load pays no window latency)')
    ap.add_argument('--no-pad-pow2', action='store_true',
                    help='do not pad merged symbolic-batch device calls to '
                         'the next power of two (padding bounds the shapes '
                         'the program meets to log2(max_batch) + 1; on by '
                         'default with micro-batching)')
    ap.add_argument('--device', default=None,
                    help="where the artifact runs, e.g. 'cuda:0' (default: "
                         'the device it was exported on; it must be of '
                         'that type)')
    args = ap.parse_args(argv)
    serve_forever(args.artifact, host=args.host, port=args.port,
                  batch_window_ms=args.batch_window_ms,
                  max_batch=args.max_batch,
                  pad_pow2=False if args.no_pad_pow2 else None,
                  eager=args.eager_batch, device=args.device)


if __name__ == '__main__':
    main()
