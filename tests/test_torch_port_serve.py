"""Parity of the port's forecast server (serve.py) with credit_tpu's: the
server on localhost (an ephemeral port, stopped after the test), GET
/health, POST /forecast (each step's mean against credit_tpu's
ForecastService on the same weights, a credit_tpu checkpoint both read),
GET /field against credit_tpu's get_saved_field on the same file (level,
smoothing, a missing file and variable), 404 for unknown paths and 400 for
steps out of [1, 400].
"""

import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from credit_tpu import serve as jserve
from credit_torch import serve
from credit_torch.data.channels import ChannelSchema
from credit_torch.grid import Grid
from credit_torch.output import save_netcdf_increment
from tests.test_torch_port_nwp import _realtime_conf, _shared_checkpoint
from torch_port_fixtures import two_torch_threads  # noqa: F401 (an autouse fixture)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(conf, port service, credit_tpu service, base URL) with the port's
    server answering in a thread."""
    root = tmp_path_factory.mktemp("serve")
    conf = _realtime_conf(root, "port", {})
    jconf = _realtime_conf(root, "jax", {})
    for c in (conf, jconf):
        c["predict"] = {"save_forecast": str(root / "tree")}
    _shared_checkpoint(conf, jconf)
    svc = serve.ForecastService(conf, device="cpu")
    jsvc = jserve.ForecastService(jconf)
    httpd = serve.make_server(conf, "127.0.0.1", 0, service=svc)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield conf, svc, jsvc, f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
        assert not thread.is_alive()


def _request(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    try:
        with urllib.request.urlopen(urllib.request.Request(url, data=data), timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_health(served):
    _, svc, _, url = served
    code, body = _request(f"{url}/health")
    assert code == 200 and body == {"status": "ok", "load_seconds": svc.load_seconds}
    assert svc.history_len == 1


@pytest.mark.parametrize("steps,init_index", [(3, None), (2, 4)])
def test_forecast_matches_reference(served, steps, init_index):
    """Each step's mean within 1e-5 relative of credit_tpu's service on the
    same weights and init index (the default: history_len)."""
    _, _, jsvc, url = served
    req = {"steps": steps} if init_index is None else {"steps": steps, "init_index": init_index}
    code, body = _request(f"{url}/forecast", req)
    assert code == 200, body
    want = jsvc.forecast(init_index or jsvc.history_len, steps)
    assert body["steps"] == steps and body["seconds"] > 0
    assert body["shapes"] == want["shapes"]
    np.testing.assert_allclose(body["channel_mean_per_step"], want["channel_mean_per_step"],
                               rtol=1e-5, atol=1e-6)


def test_steps_out_of_range_and_unknown_paths(served):
    _, _, _, url = served
    for steps in (0, 401):
        code, body = _request(f"{url}/forecast", {"steps": steps})
        assert code == 400 and "[1, 400]" in body["error"]
    assert _request(f"{url}/nothing")[0] == 404
    assert _request(f"{url}/nothing", {"steps": 1})[0] == 404
    code, body = _request(f"{url}/forecast", {"steps": "many"})
    assert code == 500 and "error" in body


def test_field_matches_reference(served):
    """A file of the saved tree (the port's writer): the payload credit_tpu's
    get_saved_field gives, byte for byte, through GET /field (a 3-D variable
    at a level, smoothed; a 2-D one), and its status for a missing file or
    variable."""
    conf, _, _, url = served
    data_path = conf["predict"]["save_forecast"]
    schema = ChannelSchema.from_config(conf)
    flat = np.random.default_rng(4).standard_normal((1, 12, 24, schema.n_target)).astype(
        np.float32)
    save_netcdf_increment(flat, schema, Grid.regular(12, 24, levels=[3e4, 5e4, 7e4, 8.5e4]),
                          data_path, "2024-01-01T00Z", 6)
    for query, kw in [("variable=T&level=2&smooth=1.5",
                       {"variable": "T", "level": 2, "smooth": 1.5}),
                      ("variable=SP", {"variable": "SP"}),
                      ("variable=NOPE", {"variable": "NOPE"})]:
        code, body = _request(f"{url}/field?run_date=2024-01-01T00Z&forecast_hour=6&{query}")
        want = jserve.get_saved_field(data_path, "2024-01-01T00Z", 6, **kw)
        assert code == 200 and body == want
        assert body == serve.get_saved_field(data_path, "2024-01-01T00Z", 6, **kw)
    sp = serve.get_saved_field(data_path, "2024-01-01T00Z", 6, "SP")
    import base64

    arr = np.frombuffer(base64.b64decode(sp["data"]), np.float32).reshape(sp["shape"])
    np.testing.assert_array_equal(arr, flat[0, :, :, schema.target_names.index("SP")])
    code, body = _request(f"{url}/field?run_date=1999&forecast_hour=6&variable=T")
    assert code == 200 and body["status"].endswith("not found.") and body["data"] == ""
    assert os.path.isdir(data_path)
