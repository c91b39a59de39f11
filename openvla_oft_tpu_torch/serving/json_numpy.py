"""json-numpy compatible encoding (the reference wire format).

The reference deploy server and clients exchange observations through the
`json_numpy` package (vla-scripts/deploy.py:23-25): ndarrays serialize as
{"__numpy__": <base64 bytes>, "dtype": str, "shape": [...]}. That package is
not in this image, so this module implements the same format for interop with
unmodified reference clients.
"""

from __future__ import annotations

import base64
import json
from typing import Any

import numpy as np


def _default(obj: Any):
    if isinstance(obj, np.ndarray):
        return {
            "__numpy__": base64.b64encode(np.ascontiguousarray(obj).data).decode(),
            "dtype": str(obj.dtype),
            "shape": list(obj.shape),
        }
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    raise TypeError(f"not JSON serializable: {type(obj)}")


def _object_hook(d: dict):
    if "__numpy__" in d:
        data = base64.b64decode(d["__numpy__"])
        return np.frombuffer(data, dtype=np.dtype(d["dtype"])).reshape(d["shape"])
    return d


def dumps(obj: Any) -> str:
    return json.dumps(obj, default=_default)


def loads(s: str) -> Any:
    out = json.loads(s, object_hook=_object_hook)
    # The reference sometimes double-encodes payloads (deploy.py:85-89); plain
    # string results (e.g. "error") must pass through untouched.
    if isinstance(out, str):
        try:
            out = json.loads(out, object_hook=_object_hook)
        except json.JSONDecodeError:
            pass
    return out
