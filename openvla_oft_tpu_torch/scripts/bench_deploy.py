"""End-to-end HTTP serving bench: the deploy server over localhost.

Port of `vla_scripts/bench_deploy.py`. The bench (`scripts/bench.py`) times
`serve_action_chunk` alone; a robot client pays for a POST /act with the
json-numpy wire format (reference `vla-scripts/deploy.py:47-107`). This
script measures that against the port's server:

  p50 / p99 / mean wall time of a POST /act over localhost: the client's
  json-numpy encode, HTTP, the server's decode, the one-pass device
  preprocessing, the model, and the response back;

and itemizes the gap to the device-only number by timing the client's wire
costs (encode, decode) and the request's size on their own.

The server is the port's deploy CLI in its own process (`python -m
openvla_oft_tpu_torch.serving.deploy --pretrained_checkpoint random:{7b,tiny}
--zero_init True --fake_norm_stats True --device_preprocess True
--load_in_8bit ... --unnorm_key {platform}_bench --device ...`): zero
weights, [-1, 1] statistics under "{platform}_bench", the deploy warm-up
before it binds. `zero_init` and `fake_norm_stats` are the config fields
that replace the JAX loader's OPENVLA_ZERO_INIT and OPENVLA_FAKE_NORM_STATS.
Its log goes to a temporary file, named on stdout. The client is urllib and
`serving/json_numpy.py`; the last stdout line is the JSON summary.

    python -m openvla_oft_tpu_torch.scripts.bench_deploy [--quant {bf16,int8}]
        [--model {7b,tiny}] [--n 50] [--platform {libero,aloha}]
        [--num_images N] [--double_encode] [--no_server] [--port P] [--device cuda]

`--device` is passed to the server (the card unless `cpu`).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np

from openvla_oft_tpu_torch.serving import json_numpy

REPO = Path(__file__).resolve().parents[2]


def make_observation(num_images: int, proprio_dim: int, hw=(256, 256), seed=0) -> dict:
    """The JAX script's observation: uint8 frames and a normal proprio from
    `np.random.default_rng(seed)`, in its order."""
    rng = np.random.default_rng(seed)
    h, w = hw
    obs = {"full_image": rng.integers(0, 255, (h, w, 3), dtype=np.uint8)}
    for i in range(num_images - 1):
        obs[f"wrist_image_{i}"] = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    obs["state"] = rng.normal(size=(proprio_dim,)).astype(np.float32)
    obs["instruction"] = "pick up the black bowl and place it on the plate"
    return obs


def request_body(obs: dict, double_encode: bool = False) -> bytes:
    """The POST body: json-numpy, or the reference client's double encoding."""
    if double_encode:
        return json.dumps({"encoded": json_numpy.dumps(obs)}).encode()
    return json_numpy.dumps(obs).encode()


def post_act(url: str, body: bytes, timeout: float) -> bytes:
    req = urllib.request.Request(url, data=body, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def server_command(args) -> list:
    return [sys.executable, "-u", "-m", "openvla_oft_tpu_torch.serving.deploy",
            "--pretrained_checkpoint", f"random:{args.model}",
            "--host", "127.0.0.1", "--port", str(args.port),
            "--num_images_in_input", str(args.num_images),
            "--use_proprio", "True",
            "--device_preprocess", "True",
            "--load_in_8bit", str(args.quant == "int8"),
            "--zero_init", "True", "--fake_norm_stats", "True",
            "--unnorm_key", f"{args.platform}_bench",
            "--device", args.device]


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--port", type=int, default=0,
                    help="0 = a free port (a stale server answering on a fixed port "
                         "would bench the wrong config)")
    ap.add_argument("--n", type=int, default=50)
    ap.add_argument("--quant", default="int8", choices=["bf16", "int8"])
    ap.add_argument("--model", default="7b", choices=["7b", "tiny"],
                    help="tiny = random:tiny, the wire and host costs alone")
    ap.add_argument("--num_images", type=int, default=2)
    ap.add_argument("--platform", default="libero", choices=["libero", "aloha"])
    ap.add_argument("--double_encode", action="store_true",
                    help="the reference client's json-numpy double encoding")
    ap.add_argument("--no_server", action="store_true",
                    help="a server is already listening on --port")
    ap.add_argument("--startup_timeout", type=float, default=900.0)
    ap.add_argument("--device", default="cuda", help="the server's device")
    return ap.parse_args(argv)


def _wait_ready(url: str, body: bytes, proc, log_path: str, timeout: float) -> None:
    """Until the server answers /act without an error (startup = the
    build and the warm-up, which runs before it binds)."""
    deadline = time.time() + timeout
    last_err = None
    while time.time() < deadline:
        if proc is not None and proc.poll() is not None:
            tail = Path(log_path).read_text()[-2000:]
            raise RuntimeError(f"the server exited early ({proc.returncode}); its log "
                               f"ends:\n{tail}")
        try:
            resp = post_act(url, body, timeout=120)
            if b"error" not in resp[:20]:
                return
            last_err = resp[:200]
        except (urllib.error.URLError, ConnectionError, OSError) as e:
            last_err = e
        time.sleep(1.0)
    raise RuntimeError(f"the server never became ready: {last_err}")


def main(argv=None) -> dict:
    args = parse(argv)
    if args.port == 0:
        args.port = free_port()
    proprio_dim = {"libero": 8, "aloha": 14}[args.platform]
    obs = make_observation(args.num_images, proprio_dim)
    url = f"http://127.0.0.1:{args.port}/act"

    proc = log = None
    log_path = ""
    if not args.no_server:
        fd, log_path = tempfile.mkstemp(prefix="bench_deploy_server_", suffix=".log")
        log = os.fdopen(fd, "w")
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(REPO), env.get("PYTHONPATH")]))
        proc = subprocess.Popen(server_command(args), cwd=REPO, env=env, stdout=log,
                                stderr=subprocess.STDOUT)
        print(f"[bench_deploy] server pid={proc.pid} (log {log_path})", flush=True)
    try:
        t0 = time.perf_counter()
        body = request_body(obs, args.double_encode)
        encode_ms = (time.perf_counter() - t0) * 1e3
        _wait_ready(url, body, proc, log_path, args.startup_timeout)

        lat, decode_ms = [], 0.0
        for i in range(args.n):
            t0 = time.perf_counter()
            resp = post_act(url, body, timeout=120)
            t1 = time.perf_counter()
            out = json_numpy.loads(resp.decode())
            if isinstance(out, str):
                if out == "error" or not args.double_encode:
                    raise RuntimeError(f"server error: {out[:200]}")
                out = json_numpy.loads(out)   # the double encoding's inner string
            t2 = time.perf_counter()
            lat.append((t1 - t0) * 1e3)
            decode_ms += (t2 - t1) * 1e3
            if i == 0:
                action = np.asarray(out)
                if action.ndim != 2 or not np.isfinite(action).all():
                    raise RuntimeError(f"bad action chunk {action.shape}: {action}")
                print(f"[bench_deploy] chunk shape {action.shape}, request "
                      f"{len(body) / 1e6:.2f} MB, response {len(resp) / 1e3:.1f} kB",
                      flush=True)
    finally:
        if proc is not None:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            log.close()

    lat = np.asarray(lat)
    summary = {
        "metric": "http_act_latency",
        "platform": args.platform,
        "model": args.model,
        "quant": args.quant,
        "n": args.n,
        "p50_ms": round(float(np.percentile(lat, 50)), 2),
        "p99_ms": round(float(np.percentile(lat, 99)), 2),
        "mean_ms": round(float(lat.mean()), 2),
        "client_encode_ms": round(encode_ms, 2),
        "client_decode_ms": round(decode_ms / args.n, 3),
        "request_mb": round(len(body) / 1e6, 3),
    }
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
