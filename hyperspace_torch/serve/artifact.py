"""Frozen serving artifacts (counterpart of ``hyperspace_tpu/serve/artifact.py``).

An artifact directory holds plain numpy and JSON, written by either
package and read by either:

- ``table.npy``     — the [N, D] embedding table, bit-exact;
- ``artifact.json`` — manifold spec, model config, table shape/dtype,
  content fingerprint, source checkpoint step;
- ``index.npz``     — optional: an IVF index (``serve/index.py``:
  centroids, dense cell layout, counts) with a meta block; its content
  hash folds into the artifact fingerprint;
- ``quant.npz``     — optional: a packed scan lane (:class:`QuantPayload`,
  PQ codes and trained codebooks, or int4 nibbles and scales), hashed
  and folded in the same way;
- ``COMMITTED``     — the commit marker, written last.

Writes are atomic: everything lands in a staging directory beside the
target, the marker goes in last, and one ``os.rename`` commits.  The
fingerprint (sha256 over the canonical spec/shape/dtype JSON, the
attached index's and payload's hashes, and the table bytes) is
byte-identical to the JAX package's, so an artifact written by either
package loads in the other under the same name, int4 and PQ payloads
included.
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
INDEX_FILE = "index.npz"  # optional IVF index (serve/index.py)
QUANT_FILE = "quant.npz"  # optional packed scan lane (serve/quant.py)


def manifold_from_spec(spec: tuple):
    """The manifold a spec names (curvatures frozen as floats)."""
    from hyperspace_torch.manifolds import (Euclidean, Lorentz,
                                            PoincareBall, Product, Sphere)

    kinds = {"poincare": PoincareBall, "lorentz": Lorentz, "sphere": Sphere}
    kind = spec[0]
    if kind == "product":
        factors, dims = [], []
        for fkind, dim, c in spec[1]:
            factors.append(Euclidean() if fkind == "euclidean"
                           else kinds[fkind](float(c)))
            dims.append(int(dim))
        return Product(factors, dims)
    if kind == "euclidean":
        return Euclidean()
    if kind in kinds:
        return kinds[kind](float(spec[1]))
    raise ValueError(f"unknown manifold spec kind {kind!r}")


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


def spec_dim(spec: tuple) -> int:
    """Ambient width the spec expects of a table row (-1: any)."""
    if spec[0] == "product":
        return sum(int(d) for _k, d, _c in spec[1])
    return -1


def fingerprint_of(table: np.ndarray, spec: tuple,
                   index_fingerprint: Optional[str] = None,
                   quant_fingerprint: Optional[str] = None) -> str:
    """sha256 over the canonical spec/shape/dtype JSON and the table
    bytes — the same content gets the same name wherever it lives.  An
    attached IVF index or packed lane folds its own hash into the JSON,
    so an artifact carrying either is a different artifact than the
    bare table; without them the hash is the table-only one."""
    table = np.ascontiguousarray(table)
    doc = {"spec": spec_to_json(spec),
           "shape": list(table.shape),
           "dtype": str(table.dtype)}
    if index_fingerprint is not None:
        doc["index"] = index_fingerprint
    if quant_fingerprint is not None:
        doc["quant"] = quant_fingerprint
    h = hashlib.sha256()
    h.update(json.dumps(doc, sort_keys=True).encode())
    h.update(table.tobytes())
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class QuantPayload:
    """A packed scan-lane copy shipped inside an artifact.

    ``lane`` names the precision ("int4" | "pq"), ``arrays`` the packed
    content (pq: ``codes`` uint8 [N, m] + ``codebooks`` f32
    [m, 256, ds]; int4: ``packed`` uint8 [N, ceil(D/2)] + ``scale`` f16
    [N, 1]), ``params`` the geometry needed to decode (pq:
    ``m``/``lift_dim``/``iters``/``seed``; int4: ``dim``), and
    ``fingerprint`` the content hash :func:`load_artifact` re-verifies.
    PQ codebooks are trained, so shipping them pins which centers every
    serving replica ranks through."""

    lane: str
    arrays: dict
    params: dict
    fingerprint: str

    @property
    def num_nodes(self) -> int:
        key = "packed" if "packed" in self.arrays else "codes"
        return int(self.arrays[key].shape[0])


def quant_fingerprint_of(lane: str, arrays: dict, params: dict) -> str:
    """sha256 over the lane tag, the decode params, every array's
    shape/dtype and its bytes, arrays in sorted-key order
    (byte-identical to the JAX package's)."""
    doc = {"lane": str(lane),
           "params": {k: params[k] for k in sorted(params)},
           "arrays": {k: [list(arrays[k].shape), str(arrays[k].dtype)]
                      for k in sorted(arrays)}}
    h = hashlib.sha256()
    h.update(json.dumps(doc, sort_keys=True).encode())
    for k in sorted(arrays):
        h.update(np.ascontiguousarray(arrays[k]).tobytes())
    return h.hexdigest()


def build_quant_payload(table, spec: tuple, lane: str, *,
                        pq_m: int = 0, pq_iters: int = 6,
                        pq_seed: int = 0) -> QuantPayload:
    """Pack ``table`` for ``lane`` as a live engine would: ``"int4"``
    packs per-row nibbles and f16 scales (``serve/quant.py``);
    ``"pq"`` trains lifted-subspace codebooks (``build_pq``,
    deterministic in ``pq_seed``) and encodes every row."""
    table = np.ascontiguousarray(np.asarray(table, np.float32))
    if table.ndim != 2:
        raise ValueError(f"table must be [N, D]; got {table.shape}")
    if lane == "int4":
        from hyperspace_torch.serve.quant import pack_int4_rows

        packed, scale = pack_int4_rows(table)
        arrays = {"packed": packed, "scale": scale}
        params = {"dim": int(table.shape[1])}
    elif lane == "pq":
        from hyperspace_torch.serve.quant import build_pq

        codes, cb = build_pq(table, spec, m=pq_m, iters=pq_iters,
                             seed=pq_seed)
        arrays = {"codes": codes, "codebooks": cb.codebooks}
        params = {"m": int(cb.m), "lift_dim": int(cb.lift_dim),
                  "iters": int(cb.iters), "seed": int(cb.seed)}
    else:
        raise ValueError(
            f"quant payloads cover lanes ('int4', 'pq'); got {lane!r}")
    return QuantPayload(lane=lane, arrays=arrays, params=params,
                        fingerprint=quant_fingerprint_of(
                            lane, arrays, params))


@dataclasses.dataclass(frozen=True)
class ServingArtifact:
    table: np.ndarray           # [N, D] host array, bit-exact
    manifold_spec: tuple        # canonical spec tuple
    model_config: dict
    fingerprint: str
    step: Optional[int] = None  # source checkpoint step, if any
    index: Optional[object] = None   # ServingIndex (serve/index.py)
    quant: Optional[QuantPayload] = None  # packed scan lane

    @property
    def num_nodes(self) -> int:
        return int(self.table.shape[0])

    @property
    def dim(self) -> int:
        return int(self.table.shape[1])


def _make_artifact(table, spec, model_config, step, index=None,
                   quant=None) -> ServingArtifact:
    table = np.ascontiguousarray(np.asarray(table))
    if table.ndim != 2:
        raise ValueError(f"serving table must be [N, D]; got {table.shape}")
    spec = tuple(spec)
    want = spec_dim(spec)
    if want >= 0 and table.shape[1] != want:
        raise ValueError(
            f"table width {table.shape[1]} != product spec width {want}")
    if index is not None:
        if int(index.num_nodes) != table.shape[0]:
            raise ValueError(
                f"index covers {index.num_nodes} rows; table has "
                f"{table.shape[0]} — rebuild the index for THIS table")
        if int(index.centroids.shape[1]) != table.shape[1]:
            raise ValueError(
                f"index centroid width {index.centroids.shape[1]} != "
                f"table width {table.shape[1]}")
    if quant is not None and int(quant.num_nodes) != table.shape[0]:
        raise ValueError(
            f"quant payload covers {quant.num_nodes} rows; table has "
            f"{table.shape[0]} — re-pack for THIS table")
    return ServingArtifact(
        table=table, manifold_spec=spec,
        model_config=dict(model_config or {}),
        fingerprint=fingerprint_of(
            table, spec, None if index is None else index.fingerprint,
            None if quant is None else quant.fingerprint),
        step=None if step is None else int(step), index=index, quant=quant)


def export_artifact(directory: str, table, manifold_spec: tuple, *,
                    model_config: Optional[dict] = None,
                    step: Optional[int] = None,
                    overwrite: bool = False,
                    index=None, quant=None) -> ServingArtifact:
    """Write a serving artifact atomically; returns the artifact written.

    ``index`` (a :class:`~hyperspace_torch.serve.index.ServingIndex`)
    and ``quant`` (a :class:`QuantPayload`) ship inside the artifact.
    An existing artifact at ``directory`` is an error unless
    ``overwrite=True``; the replace is rename-then-delete, and an
    interrupt between the renames puts the old artifact back."""
    art = _make_artifact(table, manifold_spec, model_config, step, index,
                         quant)
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
        if art.index is not None:
            np.savez(os.path.join(staging, INDEX_FILE),
                     centroids=art.index.centroids, cells=art.index.cells,
                     counts=art.index.counts)
            meta["index"] = {
                "ncells": art.index.ncells, "max_cell": art.index.max_cell,
                "num_nodes": art.index.num_nodes, "iters": art.index.iters,
                "seed": art.index.seed,
                "fingerprint": art.index.fingerprint,
            }
        if art.quant is not None:
            np.savez(os.path.join(staging, QUANT_FILE), **art.quant.arrays)
            meta["quant"] = {
                "lane": art.quant.lane,
                "params": dict(art.quant.params),
                "arrays": sorted(art.quant.arrays),
                "fingerprint": art.quant.fingerprint,
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
    """Load a committed artifact and verify its content fingerprint,
    and those of its index and packed lane.

    Raises ``FileNotFoundError`` for a missing or uncommitted directory
    and ``ValueError`` for a fingerprint mismatch, an unknown version,
    or a meta block naming a payload that is missing."""
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
    table = np.load(os.path.join(directory, TABLE_FILE))
    spec = spec_from_json(meta["manifold"])
    index = None
    if meta.get("index") is not None:
        from hyperspace_torch.serve.index import (ServingIndex,
                                                  index_fingerprint_of)

        ipath = os.path.join(directory, INDEX_FILE)
        if not os.path.isfile(ipath):
            raise ValueError(
                f"artifact meta names an index but {INDEX_FILE} is "
                f"missing at {directory}")
        with np.load(ipath) as z:
            centroids = np.ascontiguousarray(z["centroids"])
            cells = np.ascontiguousarray(z["cells"])
            counts = np.ascontiguousarray(z["counts"])
        try:
            imeta = {k: meta["index"][k] for k in
                     ("num_nodes", "iters", "seed", "fingerprint")}
        except KeyError as e:
            raise ValueError(
                f"artifact index meta at {directory} is missing {e}") from None
        ifp = index_fingerprint_of(
            centroids, cells, counts, num_nodes=int(imeta["num_nodes"]),
            iters=int(imeta["iters"]), seed=int(imeta["seed"]))
        if ifp != imeta["fingerprint"]:
            raise ValueError(
                f"index fingerprint mismatch at {directory}: meta says "
                f"{imeta['fingerprint'][:12]}…, content is {ifp[:12]}…")
        index = ServingIndex(
            centroids=centroids, cells=cells, counts=counts,
            num_nodes=int(imeta["num_nodes"]), iters=int(imeta["iters"]),
            seed=int(imeta["seed"]), fingerprint=ifp)
    quant = None
    if meta.get("quant") is not None:
        qpath = os.path.join(directory, QUANT_FILE)
        if not os.path.isfile(qpath):
            raise ValueError(
                f"artifact meta names a quant lane but {QUANT_FILE} is "
                f"missing at {directory}")
        try:
            lane = meta["quant"]["lane"]
            params = dict(meta["quant"]["params"])
            names = list(meta["quant"]["arrays"])
            qfp_meta = meta["quant"]["fingerprint"]
        except KeyError as e:
            raise ValueError(
                f"artifact quant meta at {directory} is missing {e}") \
                from None
        with np.load(qpath) as z:
            missing = sorted(set(names) - set(z.files))
            if missing:
                raise ValueError(
                    f"quant payload at {directory} is missing arrays "
                    f"{missing}")
            arrays = {k: np.ascontiguousarray(z[k]) for k in names}
        qfp = quant_fingerprint_of(lane, arrays, params)
        if qfp != qfp_meta:
            raise ValueError(
                f"quant fingerprint mismatch at {directory}: meta says "
                f"{qfp_meta[:12]}…, content is {qfp[:12]}…")
        quant = QuantPayload(lane=lane, arrays=arrays, params=params,
                             fingerprint=qfp)
    fp = fingerprint_of(table, spec,
                        None if index is None else index.fingerprint,
                        None if quant is None else quant.fingerprint)
    if fp != meta["fingerprint"]:
        raise ValueError(
            f"artifact fingerprint mismatch at {directory}: "
            f"meta says {meta['fingerprint'][:12]}…, content is {fp[:12]}…")
    return ServingArtifact(
        table=table, manifold_spec=spec,
        model_config=meta.get("model_config") or {},
        fingerprint=fp, step=meta.get("step"), index=index, quant=quant)


# --- checkpoint → artifact ----------------------------------------------------


def export_from_checkpoint(ckpt_dir: str, out_dir: str, *,
                           workload: str,
                           model_config: Optional[dict] = None,
                           step: Optional[int] = None,
                           overwrite: bool = False,
                           index_ncells: Optional[int] = None,
                           quant_lane: Optional[str] = None,
                           device="cuda") -> ServingArtifact:
    """Export a committed step of the port's checkpoint (the newest by
    default) as a serving artifact.

    Reads the plain tree through
    :func:`hyperspace_torch.train.checkpoint.restore_params_only` and
    takes the table and frozen geometry per workload, as JAX does:

    - ``poincare`` / ``lorentz``: ``tree["table"]`` on the ball or the
      hyperboloid of curvature ``model_config["c"]`` (required: the
      trained curvature is not in the checkpoint);
    - ``product``: ``tree["params"]["table"]`` with the learned
      curvatures ``softplus(tree["params"]["c_raw"])`` (the softplus the
      port's model applies, in ``c_raw``'s dtype) frozen into the spec;
      the factor layout from ``model_config["factors"]`` or
      ``ProductEmbedConfig``'s default.

    ``index_ncells`` builds an IVF index into the artifact (``<= 0``
    picks ``auto_ncells`` ≈ √N); ``quant_lane`` (``"int4"`` or
    ``"pq"``) ships that lane's payload.  The index is built on ``device`` (CUDA unless the caller asks for the
    CPU).
    """
    import torch

    from hyperspace_torch.train.checkpoint import restore_params_only

    tree, ck_step = restore_params_only(ckpt_dir, step=step)
    cfg = dict(model_config or {})
    if workload in ("poincare", "lorentz"):
        if "c" not in cfg:
            raise ValueError(
                f"{workload} export requires model_config['c'] (the "
                "curvature the run trained with; it is not recoverable "
                "from the checkpoint state)")
        spec = (workload, float(cfg["c"]))
        table = tree["table"].numpy()
    elif workload == "product":
        factors = cfg.get("factors")
        if factors is None:
            from hyperspace_torch.models.product_embed import \
                ProductEmbedConfig

            factors = list(ProductEmbedConfig.factors)
        curv = torch.nn.functional.softplus(
            tree["params"]["c_raw"]).numpy()
        factors = [tuple(f) for f in factors]
        want = sum(1 for kind, _d in factors if kind != "euclidean")
        if want != curv.shape[0]:
            raise ValueError(
                f"factor layout {factors} expects {want} learned "
                f"curvatures; checkpoint has {curv.shape[0]}")
        fspec, i = [], 0
        for kind, dim in factors:
            if kind == "euclidean":
                fspec.append(("euclidean", int(dim), 0.0))
            else:
                fspec.append((kind, int(dim), float(curv[i])))
                i += 1
        spec = ("product", tuple(fspec))
        table = tree["params"]["table"].numpy()
        cfg["factors"] = [list(f) for f in factors]
    else:
        raise ValueError(
            f"export_from_checkpoint: unknown workload {workload!r} "
            "(want poincare|lorentz|product)")
    index = None
    if index_ncells is not None:
        from hyperspace_torch.serve.index import auto_ncells, build_index

        ncells = int(index_ncells)
        if ncells <= 0:
            ncells = auto_ncells(int(table.shape[0]))
        index = build_index(table, spec, ncells, device=device)
    quant = (build_quant_payload(table, spec, quant_lane)
             if quant_lane else None)
    return export_artifact(out_dir, table, spec, model_config=cfg,
                           step=ck_step, overwrite=overwrite, index=index,
                           quant=quant)
