"""HTTP action server: POST /act -> action chunk.

Reference: `vla-scripts/deploy.py:47-155` (`OpenVLAServer` on FastAPI).
This implementation serves the same wire contract — json(-numpy) observation
dict + "instruction" in, action array out, including the "encoded"
double-encoding escape hatch — on FastAPI/uvicorn when installed, else on a
stdlib ThreadingHTTPServer (no extra dependencies, same endpoints).

The policy callable is injected, so the server is model-agnostic: anything
with `predict(observation: dict, instruction: str) -> np.ndarray`
works (vla_scripts/deploy.py::OpenVLAServer.predict is the OpenVLA one).

Annotations are not postponed in this file: FastAPI resolves the route's
`request: Request` from the function's annotations, and `Request` is
imported inside `_run_fastapi`, where a postponed (string) annotation would
not find it. FastAPI would then read `request` as a missing query parameter
and answer every /act with 422.
"""

import http.server
import json
import logging
import threading
import time
import traceback
from typing import Any, Callable, Dict, Optional

import numpy as np

from openvla_oft_tpu_torch.serving import json_numpy

logger = logging.getLogger(__name__)

PredictFn = Callable[[Dict[str, Any], str], np.ndarray]


def handle_act_payload(payload: Dict[str, Any], predict: PredictFn):
    """Core /act handler (reference `get_server_action`, deploy.py:76-102)."""
    try:
        double_encode = "encoded" in payload
        if double_encode:
            assert len(payload.keys()) == 1, "Only uses encoded payload!"
            payload = json_numpy.loads(payload["encoded"]) \
                if isinstance(payload["encoded"], str) else payload["encoded"]
        observation = payload
        instruction = observation["instruction"]
        action = predict(observation, instruction)
        if double_encode:
            return json_numpy.dumps(np.asarray(action))
        return np.asarray(action)
    except Exception:
        logger.error(traceback.format_exc())
        logger.warning(
            "Your request threw an error; expected format: "
            "{'observation': dict, 'instruction': str}")
        return "error"


class _StdlibHandler(http.server.BaseHTTPRequestHandler):
    predict: PredictFn = None  # set by server factory

    def do_POST(self):  # noqa: N802
        if self.path.rstrip("/") != "/act":
            self.send_error(404)
            return
        length = int(self.headers.get("Content-Length", 0))
        payload = json_numpy.loads(self.rfile.read(length).decode())
        result = handle_act_payload(payload, type(self).predict)
        body = json_numpy.dumps(result).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        pass


class ActionServer:
    """Serves /act; FastAPI when available, stdlib otherwise."""

    def __init__(self, predict: PredictFn):
        self.predict = predict
        self._httpd = None

    def run(self, host: str = "0.0.0.0", port: int = 8777,
            background: bool = False):
        try:
            return self._run_fastapi(host, port, background)
        except ImportError:
            return self._run_stdlib(host, port, background)

    def _run_fastapi(self, host, port, background=False):
        from fastapi import FastAPI, Request
        from fastapi.responses import JSONResponse
        import uvicorn

        app = FastAPI()

        @app.post("/act")
        async def act(request: Request):
            # Decode the raw body with the json-numpy hook: the reference
            # relies on json_numpy.patch() globally patching json before
            # FastAPI imports; FastAPI's own body parse (plain json.loads)
            # would leave {'__numpy__': ...} dicts un-decoded and every
            # standard client request would fail the image check.
            payload = json_numpy.loads((await request.body()).decode())
            result = handle_act_payload(payload, self.predict)
            if isinstance(result, np.ndarray):
                return JSONResponse(json.loads(json_numpy.dumps(result)))
            return JSONResponse(result)

        config = uvicorn.Config(app, host=host, port=port, log_level="warning")
        server = uvicorn.Server(config)
        self._uvicorn = server
        if background:
            self._thread = threading.Thread(target=server.run, daemon=True)
            self._thread.start()
            # Bound before returning, as the stdlib server is: a client may
            # send its first request at once.
            deadline = time.monotonic() + 60.0
            while not server.started:
                if not self._thread.is_alive() or time.monotonic() > deadline:
                    raise RuntimeError(f"uvicorn did not start on {host}:{port}")
                time.sleep(0.01)
            return server
        server.run()

    def _run_stdlib(self, host, port, background=False):
        handler = type("Handler", (_StdlibHandler,), {"predict": staticmethod(self.predict)})
        self._httpd = http.server.ThreadingHTTPServer((host, port), handler)
        if background:
            t = threading.Thread(target=self._httpd.serve_forever, daemon=True)
            t.start()
            return self._httpd
        self._httpd.serve_forever()

    def shutdown(self):
        if self._httpd is not None:
            self._httpd.shutdown()
        if getattr(self, "_uvicorn", None) is not None:
            self._uvicorn.should_exit = True
            if getattr(self, "_thread", None) is not None:
                self._thread.join(timeout=30.0)


def get_action_from_server(observation: Dict[str, Any],
                           server_endpoint: str = "http://0.0.0.0:8777/act"):
    """Client (reference openvla_utils.py:799-816), stdlib urllib instead of
    requests."""
    import urllib.request

    body = json_numpy.dumps(observation).encode()
    req = urllib.request.Request(server_endpoint, data=body,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req) as resp:
        return json_numpy.loads(resp.read().decode())
