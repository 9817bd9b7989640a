"""Frozen serving artifacts (counterpart of ``hyperspace_tpu/serve/artifact.py``).

An artifact directory holds plain numpy and JSON, written by either
package and read by either:

- ``table.npy``     — the [N, D] embedding table, bit-exact;
- ``artifact.json`` — manifold spec, model config, table shape/dtype,
  content fingerprint, source checkpoint step;
- ``COMMITTED``     — the commit marker, written last.

Writes are atomic: everything lands in a staging directory beside the
target, the marker goes in last, and one ``os.rename`` commits.  The
fingerprint (sha256 over the canonical spec/shape/dtype JSON and the
table bytes) is byte-identical to the JAX package's, so the same table
and spec name the same content in both.

Artifacts carrying an IVF index (``index.npz``) or a packed scan lane
(``quant.npz``) are refused: those lanes are not ported yet.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
from typing import Optional

import numpy as np

ARTIFACT_VERSION = 1
COMMIT_MARKER = "COMMITTED"
META_FILE = "artifact.json"
TABLE_FILE = "table.npy"


def spec_to_json(spec: tuple) -> dict:
    kind = spec[0]
    if kind == "product":
        return {"kind": "product", "factors": [
            {"kind": fk, "dim": int(d), "c": float(c)}
            for fk, d, c in spec[1]]}
    return {"kind": kind, "c": float(spec[1])}


def spec_from_json(doc: dict) -> tuple:
    kind = doc["kind"]
    if kind == "product":
        return ("product", tuple(
            (f["kind"], int(f["dim"]), float(f.get("c", 0.0)))
            for f in doc["factors"]))
    return (kind, float(doc.get("c", 0.0)))


def fingerprint_of(table: np.ndarray, spec: tuple) -> str:
    """sha256 over the canonical spec/shape/dtype JSON and the table
    bytes — the same content gets the same name wherever it lives."""
    table = np.ascontiguousarray(table)
    doc = {"spec": spec_to_json(spec),
           "shape": list(table.shape),
           "dtype": str(table.dtype)}
    h = hashlib.sha256()
    h.update(json.dumps(doc, sort_keys=True).encode())
    h.update(table.tobytes())
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class ServingArtifact:
    table: np.ndarray           # [N, D] host array, bit-exact
    manifold_spec: tuple        # canonical spec tuple
    model_config: dict
    fingerprint: str
    step: Optional[int] = None  # source checkpoint step, if any

    @property
    def num_nodes(self) -> int:
        return int(self.table.shape[0])

    @property
    def dim(self) -> int:
        return int(self.table.shape[1])


def export_artifact(directory: str, table, manifold_spec: tuple, *,
                    model_config: Optional[dict] = None,
                    step: Optional[int] = None,
                    overwrite: bool = False) -> ServingArtifact:
    """Write a serving artifact atomically; returns the artifact written.

    An existing artifact at ``directory`` is an error unless
    ``overwrite=True``; the replace is rename-then-delete, and an
    interrupt between the renames puts the old artifact back."""
    table = np.ascontiguousarray(np.asarray(table))
    if table.ndim != 2:
        raise ValueError(f"serving table must be [N, D]; got {table.shape}")
    art = ServingArtifact(
        table=table, manifold_spec=tuple(manifold_spec),
        model_config=dict(model_config or {}),
        fingerprint=fingerprint_of(table, manifold_spec),
        step=None if step is None else int(step))
    directory = os.path.abspath(directory)
    parent = os.path.dirname(directory)
    os.makedirs(parent, exist_ok=True)
    if os.path.exists(directory) and not overwrite:
        raise FileExistsError(
            f"serving artifact already exists at {directory} "
            "(pass overwrite=True to replace)")
    staging = os.path.join(
        parent, f".{os.path.basename(directory)}.tmp.{os.getpid()}")
    if os.path.exists(staging):
        shutil.rmtree(staging)
    os.makedirs(staging)
    try:
        np.save(os.path.join(staging, TABLE_FILE), art.table)
        meta = {
            "version": ARTIFACT_VERSION,
            "manifold": spec_to_json(art.manifold_spec),
            "model_config": art.model_config,
            "table": {"shape": list(art.table.shape),
                      "dtype": str(art.table.dtype)},
            "fingerprint": art.fingerprint,
            "step": art.step,
        }
        with open(os.path.join(staging, META_FILE), "w") as f:
            json.dump(meta, f, indent=2, sort_keys=True)
        # marker LAST: everything before it is on disk when it appears
        with open(os.path.join(staging, COMMIT_MARKER), "w") as f:
            f.write(art.fingerprint + "\n")
        if os.path.exists(directory):
            old = directory + f".old.{os.getpid()}"
            if os.path.exists(old):
                shutil.rmtree(old)
            os.rename(directory, old)
            try:
                os.rename(staging, directory)
            except BaseException:
                os.rename(old, directory)
                raise
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.rename(staging, directory)
    except BaseException:
        shutil.rmtree(staging, ignore_errors=True)
        raise
    return art


def is_committed(directory: str) -> bool:
    """Whether ``directory`` holds a committed serving artifact."""
    return (os.path.isfile(os.path.join(directory, COMMIT_MARKER))
            and os.path.isfile(os.path.join(directory, META_FILE))
            and os.path.isfile(os.path.join(directory, TABLE_FILE)))


def load_artifact(directory: str) -> ServingArtifact:
    """Load a committed artifact and verify its content fingerprint.

    Raises ``FileNotFoundError`` for a missing or uncommitted directory
    and ``ValueError`` for a fingerprint mismatch, an unknown version,
    or an artifact that carries an IVF index or a packed scan lane."""
    directory = os.path.abspath(directory)
    if not is_committed(directory):
        raise FileNotFoundError(
            f"no committed serving artifact at {directory}")
    with open(os.path.join(directory, META_FILE)) as f:
        meta = json.load(f)
    if int(meta.get("version", -1)) != ARTIFACT_VERSION:
        raise ValueError(
            f"artifact version {meta.get('version')!r} != "
            f"{ARTIFACT_VERSION} at {directory}")
    for key in ("index", "quant"):
        if meta.get(key) is not None:
            raise ValueError(
                f"artifact at {directory} carries a {key!r} payload; "
                "IVF indexes and packed scan lanes are not ported yet")
    table = np.load(os.path.join(directory, TABLE_FILE))
    spec = spec_from_json(meta["manifold"])
    fp = fingerprint_of(table, spec)
    if fp != meta["fingerprint"]:
        raise ValueError(
            f"artifact fingerprint mismatch at {directory}: "
            f"meta says {meta['fingerprint'][:12]}…, content is {fp[:12]}…")
    return ServingArtifact(
        table=table, manifold_spec=spec,
        model_config=meta.get("model_config") or {},
        fingerprint=fp, step=meta.get("step"))
