"""HTTP forecast server (port of credit_tpu/serve.py).

CREDIT's serving path (docs/source/serve.md: the model resident on the
accelerator, POST /forecast runs a rollout, GET /health) on the standard
library's http.server, as credit_tpu has it: the model stays on the card
behind a lock, and GET /field serves one field of a saved rollout tree
(CREDIT applications/data_server.py).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from credit_torch import resolve_device

logger = logging.getLogger(__name__)


class ForecastService:
    """The model resident on `device` (CUDA unless the caller asks for the
    CPU) and its rollout engine: save_loc's checkpoint folded for inference
    (`experiment._load_engine`, no postblocks, as credit_tpu's engine here),
    one forecast at a time."""

    def __init__(self, conf: dict, device="cuda"):
        from credit_torch.applications.experiment import _load_engine

        t0 = time.time()
        self.conf = conf
        self.exp, self.engine = _load_engine(conf, resolve_device(device), postblocks=False)
        self.history_len = self.engine.history_len
        self.load_seconds = time.time() - t0
        self.lock = threading.Lock()
        logger.info("model loaded in %.1fs", self.load_seconds)

    def forecast(self, init_index: int, steps: int) -> dict:
        """A `steps`-step rollout from the dataset's input at init_index:
        the seconds it took and the mean of each step's prediction."""
        ds = self.exp["dataset"]
        x0 = ds.input_at(init_index)[None]

        def forcing(s):
            f = ds.forcing_at(init_index + s)
            return None if f is None else f[None]

        with self.lock:
            t0 = time.time()
            outs = self.engine.run(x0, steps, forcing_provider=forcing)
            dt = time.time() - t0
        means = [float(np.mean(o)) for o in outs]
        return {"steps": steps, "seconds": dt, "channel_mean_per_step": means,
                "shapes": [list(o.shape) for o in outs[:1]]}


def get_saved_field(data_path: str, run_date: str, forecast_hour: int, variable: str,
                    level: int | None = None, smooth: float = 0.0) -> dict:
    """One field of a saved rollout tree as a base64 payload (CREDIT
    applications/data_server.py:35-71: the run_date/fhr netCDF file, the
    level, optional gaussian smoothing, {status, data, dtype, shape} for
    map front ends)."""
    import base64

    from credit_torch.utils.ncio import open_dataset

    path = os.path.join(data_path, run_date, f"pred_{run_date}_{forecast_hour:03d}.nc")
    if not os.path.exists(path):
        return {"status": f"File {path} not found.", "data": "",
                "dtype": "<f4", "shape": [0, 0]}
    ds = open_dataset(path)
    if variable not in ds:
        return {"status": f"Variable {variable} not in {path}.", "data": "",
                "dtype": "<f4", "shape": [0, 0]}
    v = ds[variable]
    arr = np.asarray(v.values)
    dims = tuple(v.dims)
    if "time" in dims:
        arr = arr[0]
        dims = dims[1:]
    if arr.ndim == 3:  # (level, lat, lon)
        arr = arr[int(level or 0)]
    if smooth > 0:
        from scipy.ndimage import gaussian_filter

        arr = gaussian_filter(arr, smooth)
    arr = np.ascontiguousarray(arr, np.float32)
    return {"status": "ok", "data": base64.b64encode(arr.tobytes()).decode("utf-8"),
            "dtype": arr.dtype.str, "shape": list(arr.shape)}


def make_server(conf: dict, host: str = "127.0.0.1", port: int = 8000,
                service: ForecastService | None = None, device="cuda") -> ThreadingHTTPServer:
    """The server `serve` runs, bound and not yet serving: GET /health,
    GET /field (from predict.save_forecast), POST /forecast with steps in
    [1, 400]. Its `serve_forever` answers; `shutdown` stops it."""
    svc = service or ForecastService(conf, device)
    data_path = conf.get("predict", {}).get("save_forecast", ".")

    class Handler(BaseHTTPRequestHandler):
        def _json(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._json(200, {"status": "ok", "load_seconds": svc.load_seconds})
            elif self.path.startswith("/field"):
                from urllib.parse import parse_qs, urlparse

                q = parse_qs(urlparse(self.path).query)

                def one(key, default=None, cast=str):
                    vals = q.get(key)
                    return cast(vals[0]) if vals else default

                try:
                    self._json(200, get_saved_field(
                        data_path, run_date=one("run_date", ""),
                        forecast_hour=one("forecast_hour", 1, int),
                        variable=one("variable", ""), level=one("level", None, int),
                        smooth=one("smooth", 0.0, float)))
                except Exception as e:  # noqa: BLE001 - surface as 500
                    logger.exception("field lookup failed")
                    self._json(500, {"error": str(e)})
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/forecast":
                return self._json(404, {"error": "not found"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                steps = int(req.get("steps", 4))
                init_index = int(req.get("init_index", svc.history_len))
                if steps < 1 or steps > 400:
                    return self._json(400, {"error": "steps must be in [1, 400]"})
                self._json(200, svc.forecast(init_index, steps))
            except Exception as e:  # noqa: BLE001 - surface as 500
                logger.exception("forecast failed")
                self._json(500, {"error": str(e)})

        def log_message(self, fmt, *args):
            logger.info("%s " + fmt, self.client_address[0], *args)

    return ThreadingHTTPServer((host, port), Handler)


def serve(conf: dict, host: str = "127.0.0.1", port: int = 8000,
          service: ForecastService | None = None, device="cuda"):
    """credit-torch serve: `make_server`, served until interrupted."""
    httpd = make_server(conf, host, port, service, device)
    logger.info("serving on http://%s:%d", host, port)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
