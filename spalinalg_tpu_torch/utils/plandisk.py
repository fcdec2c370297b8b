"""On-disk persistence of host-built plans (counterpart of
``spalinalg_tpu/utils/plandisk.py``).

The supernodal Cholesky's host plan (ordering, symbolic analysis, index
plans) costs seconds per structure. Programs that factor the same
sparsity in a new process reload it from disk, keyed by a hash of the
structure, instead of building it again. The port persists only what the
JAX package persists and the port builds: the supernodal Cholesky plan
(JAX kind ``"snchol"``). The route and pair plans are TPU workarounds with
no counterpart here, and the JAX package persists no LU plan.

The JAX package's rules hold:

- storage is a non-executable ``npz`` archive: a plan's dataclasses are
  flattened to arrays and a JSON manifest, and rebuilt through an
  allowlist of classes with ``object.__new__``; nothing in the file is
  ever executed, and ``allow_pickle`` stays off;
- the key hashes the kind, the layout version, the port's native-source
  hash (``native/src/host_kernels.cpp``: the orderings run there) and the
  structure (its arrays and scalars);
- a write goes to a per-process temporary file, then ``os.replace``;
- the directory is capped (``$SPALINALG_PLAN_CACHE_MAX_MB``, default
  2048) with LRU eviction: loads refresh a file's mtime, saves evict the
  oldest first;
- any load failure (a corrupt file, a stale layout) rebuilds silently:
  the cache is an optimisation, never a correctness dependency. Fields
  that are runtime caches (``_tables``, the per-device upload of a plan's
  index arrays) are not persisted and come back empty.

Location: ``$SPALINALG_PLAN_CACHE`` names a directory shared with the JAX
package, whose plans have other layouts, so the port keeps its own
``torch/`` subdirectory of it; ``0``, ``off`` or ``none`` disables the
cache. The default is ``~/.cache/spalinalg_tpu_torch/plans``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
from typing import Callable, Optional

import numpy as np

__all__ = ["plan_cache_dir", "load_or_build"]

_VERSION = 1  # bump when plan layouts or build algorithms change
_RUNTIME = ("_tables",)  # runtime caches: not persisted
_native_hash_cache = None


def _native_hash() -> str:
    global _native_hash_cache
    if _native_hash_cache is None:
        from ..native.lib import SOURCE

        _native_hash_cache = hashlib.sha256(
            SOURCE.read_bytes()).hexdigest()[:16]
    return _native_hash_cache


def plan_cache_dir() -> Optional[str]:
    """The port's plan directory (created), or None when disabled or not
    writable."""
    env = os.environ.get("SPALINALG_PLAN_CACHE", "")
    if env.lower() in ("0", "off", "none"):
        return None
    path = (os.path.join(env, "torch") if env
            else os.path.expanduser("~/.cache/spalinalg_tpu_torch/plans"))
    try:
        os.makedirs(path, exist_ok=True)
        return path
    except OSError:
        return None


def _structure_key(kind: str, arrays, scalars) -> str:
    h = hashlib.sha256()
    h.update(f"{kind}:v{_VERSION}:{_native_hash()}".encode())
    for s in scalars:
        h.update(str(s).encode())
        h.update(b";")
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------
# Non-executable (de)serialisation: plans flatten to {name: ndarray}
# plus a JSON manifest; classes come from an allowlist, never the file.
# ---------------------------------------------------------------------

def _plan_classes():
    from ..linalg.supernodal import SupernodalPlan, _Bucket
    from ..linalg.symbolic import SupernodalSymbolic

    return {"SupernodalPlan": SupernodalPlan, "_Bucket": _Bucket,
            "SupernodalSymbolic": SupernodalSymbolic}


def _encode(key, v, arrays, meta):
    if v is None or isinstance(v, (bool, int, float, str)):
        meta[key] = {"k": "s", "v": v}
    elif isinstance(v, np.ndarray):
        if v.dtype.hasobject:
            raise TypeError(f"object array in plan field {key}")
        meta[key] = {"k": "a"}
        arrays["a:" + key] = v
    elif isinstance(v, np.generic):
        meta[key] = {"k": "s", "v": v.item()}
    elif isinstance(v, (list, tuple)):
        meta[key] = {"k": "l" if isinstance(v, list) else "t", "n": len(v)}
        for i, e in enumerate(v):
            _encode(f"{key}.{i}", e, arrays, meta)
    elif isinstance(v, dict):   # keys and values both encoded, in order
        meta[key] = {"k": "d", "n": len(v)}
        for i, (dk, dv) in enumerate(v.items()):
            _encode(f"{key}#{i}k", dk, arrays, meta)
            _encode(f"{key}#{i}v", dv, arrays, meta)
    elif dataclasses.is_dataclass(v):
        name = type(v).__name__
        if name not in _plan_classes():
            raise TypeError(f"unregistered plan class {name}")
        meta[key] = {"k": "p", "cls": name}
        for f in dataclasses.fields(v):
            if f.name not in _RUNTIME:
                _encode(f"{key}/{f.name}", getattr(v, f.name), arrays, meta)
    else:
        raise TypeError(f"unserialisable field {key}: {type(v)}")


def _decode(key, arrays, meta):
    m = meta[key]
    k = m["k"]
    if k == "s":
        return m["v"]
    if k == "a":
        return arrays["a:" + key]
    if k in ("l", "t"):
        seq = [_decode(f"{key}.{i}", arrays, meta) for i in range(m["n"])]
        return seq if k == "l" else tuple(seq)
    if k == "d":
        return {_decode(f"{key}#{i}k", arrays, meta):
                _decode(f"{key}#{i}v", arrays, meta) for i in range(m["n"])}
    if k == "p":
        cls = _plan_classes()[m["cls"]]
        obj = object.__new__(cls)
        for f in dataclasses.fields(cls):
            if f.name in _RUNTIME:
                value = f.default_factory()
            else:
                fkey = f"{key}/{f.name}"
                if fkey not in meta:
                    # a field added since this file was written: rebuild
                    # rather than fill it in (load_or_build catches this)
                    raise KeyError(f"stale plan layout: missing {fkey}")
                value = _decode(fkey, arrays, meta)
            object.__setattr__(obj, f.name, value)
        return obj
    raise ValueError(f"bad manifest kind {k!r}")


def _save(path: str, plan) -> None:
    arrays, meta = {}, {}
    _encode("plan", plan, arrays, meta)
    buf = io.BytesIO()
    np.savez(buf, __meta__=np.frombuffer(json.dumps(meta).encode(),
                                         dtype=np.uint8), **arrays)
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)


def _load(path: str):
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    return _decode("plan", arrays, meta)


def _evict(cdir: str) -> None:
    cap_bytes = int(float(os.environ.get("SPALINALG_PLAN_CACHE_MAX_MB",
                                         "2048")) * 1e6)
    try:
        entries, total = [], 0
        with os.scandir(cdir) as it:
            for e in it:
                if e.is_file() and e.name.endswith(".npz"):
                    st = e.stat()
                    entries.append((st.st_mtime, st.st_size, e.path))
                    total += st.st_size
        for _mt, size, p in sorted(entries):
            if total <= cap_bytes:
                break
            try:
                os.remove(p)
            except OSError:
                continue
            total -= size
    except OSError:
        pass


def load_or_build(kind: str, arrays, scalars, build: Callable, *,
                  on_load: Optional[Callable] = None):
    """The cached plan of this structure, else ``build()``'s, stored.

    ``arrays`` and ``scalars`` define the structure's identity; ``build``
    is the host builder. ``on_load(load)``, if given, is called with the
    function that reads the file and must return its result (the caller
    times it onto the metrics recorder).
    """
    cdir = plan_cache_dir()
    if cdir is None:
        return build()
    path = os.path.join(cdir, _structure_key(kind, arrays, scalars) + ".npz")
    if os.path.exists(path):
        try:
            plan = (on_load or (lambda f: f()))(lambda: _load(path))
            os.utime(path)  # LRU recency
            return plan
        except Exception:
            pass  # corrupt file or stale layout: rebuild below
    plan = build()
    try:
        _save(path, plan)
        _evict(cdir)
    except (OSError, TypeError, ValueError):
        pass  # an unwritable cache costs a rebuild next time, nothing else
    return plan
