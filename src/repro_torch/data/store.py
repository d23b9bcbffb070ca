"""Out-of-core client store: per-client shard files + JSON manifest (a
numpy copy of ``src/repro/data/store.py``: a store written by either
package opens in the other with the same fingerprint).

``FederatedBatcher`` (see :mod:`repro_torch.data.pipeline`) only ever touches
the drawn row subsets of each client's arrays — ``build()`` reads
``ds[key][sel]`` for a per-(seed, round) selection of at most the spec's
static row capacity. ``ClientStore`` exploits that access pattern to
take C past what one host's memory holds: each client's ragged
dict-of-arrays dataset is written once to per-client ``.npy`` shard
files, and reads open a memory map, gather exactly the selected rows
into a fresh array, and unmap — so a training round's peak host RSS is
O(K * N * row_bytes) regardless of the total dataset size.

Layout (one directory per federation)::

    <store_dir>/
      manifest.json              # version, n_clients, per-client
                                 #   key -> {shape, dtype}, val section,
                                 #   free-form meta (task dims, seeds)
      val/val_a.npy ...          # replicated server validation set
      client_00000/partial_a.npy # one shard file per (client, key)
      client_00000/frag_ids_a.npy
      ...

Design points:

- **Manifest is the index.** Row counts, dtypes, and shapes live in
  ``manifest.json``; ragged-ness checks and ``_draw`` sizing never open
  a shard file. A missing key means that client holds no such modality
  (zero-row arrays are recorded in the manifest but read back as
  materialized ``np.zeros`` — a zero-length file cannot be mmapped).
- **Writes are atomic.** Shards and manifest are staged in
  ``<store_dir>.tmp`` and ``os.rename``d into place, mirroring the
  checkpoint store's crash-safety contract: a partial import can never
  be mistaken for a complete store.
- **Bit-exact round-trip.** ``.npy`` preserves dtype and bytes exactly,
  so ``FederatedBatcher.from_store`` produces batches bit-identical to
  the in-memory loader's for the same (seed, round).
- **Multi-host seam.** ``rows_for_clients(ids, rows)`` reads specific
  row subsets of specific clients only — a future mesh-sliced loader
  calls it with its local shard of the sampled client ids and
  copies the result to its device, never touching other hosts' clients.
- **Checkpoint identity.** ``fingerprint()`` hashes the canonical
  manifest; ``repro_torch.launch.train_federated`` stamps it into round-state
  checkpoint metadata and refuses to resume against a different store.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil

import numpy as np

MANIFEST_NAME = "manifest.json"
STORE_VERSION = 1

_VAL_KEYS = ("val_a", "val_b", "val_y")


def _client_dirname(cid: int) -> str:
    return f"client_{cid:05d}"


class ShardRows:
    """Lazy row-reader for one (client, key) shard file.

    Supports exactly the accesses ``FederatedBatcher.build`` performs on
    an in-memory array — ``len(v)`` and ``v[sel]`` — plus ``.shape`` and
    ``.dtype`` from the manifest. ``__getitem__`` opens the ``.npy``
    memory map, materializes the selected rows, and closes the map, so
    no file pages stay resident between reads.
    """

    def __init__(self, path: str, shape: tuple, dtype: np.dtype):
        self.path = path
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)

    def __len__(self) -> int:
        return self.shape[0]

    def __getitem__(self, sel) -> np.ndarray:
        if self.shape[0] == 0:
            return np.zeros(self.shape, self.dtype)[sel]
        mm = np.lib.format.open_memmap(self.path, mode="r")
        try:
            return np.array(mm[sel])  # gather + copy off the map
        finally:
            owner = getattr(mm, "_mmap", None)
            del mm
            if owner is not None:
                owner.close()

    def read(self) -> np.ndarray:
        """Materialize the whole shard (val set, tests)."""
        return self[slice(None)]


class ClientView:
    """Mapping-compatible view of one client's shards.

    Quacks like the dict-of-arrays client datasets ``FederatedBatcher``
    takes — ``keys()``/``__iter__``/``get``/``__getitem__``/``len`` —
    with :class:`ShardRows` values, so ``dict(view)`` stays lazy.
    """

    def __init__(self, store: "ClientStore", cid: int):
        self._store = store
        self._cid = cid
        self._keys = tuple(store.client_keys(cid))

    def keys(self):
        return self._keys

    def __iter__(self):
        return iter(self._keys)

    def __len__(self) -> int:
        return len(self._keys)

    def __contains__(self, key: str) -> bool:
        return key in self._keys

    def __getitem__(self, key: str) -> ShardRows:
        if key not in self._keys:
            raise KeyError(key)
        return self._store.shard(self._cid, key)

    def get(self, key: str, default=None):
        return self._store.shard(self._cid, key) if key in self._keys else default


class ClientStore:
    """Read handle over an on-disk federation store (see module doc)."""

    def __init__(self, store_dir: str):
        self.store_dir = str(store_dir)
        mpath = os.path.join(self.store_dir, MANIFEST_NAME)
        if not os.path.isfile(mpath):
            # a crashed overwrite swap can leave the complete previous
            # store only at <dir>.old (mirroring the checkpoint store's
            # contract) — pure read-path fallback, no renames here
            old = self.store_dir.rstrip("/") + ".old"
            if os.path.isfile(os.path.join(old, MANIFEST_NAME)):
                self.store_dir = old
                mpath = os.path.join(old, MANIFEST_NAME)
            else:
                raise FileNotFoundError(
                    f"no client store at {self.store_dir!r} (missing "
                    f"{MANIFEST_NAME}; run the train_federated `import` "
                    "subcommand to create one)")
        with open(mpath) as f:
            self.manifest = json.load(f)
        if self.manifest.get("version") != STORE_VERSION:
            raise ValueError(
                f"store version {self.manifest.get('version')!r} != "
                f"{STORE_VERSION} (incompatible layout)")

    # ---- manifest accessors (no file IO) ----

    @property
    def n_clients(self) -> int:
        return int(self.manifest["n_clients"])

    @property
    def meta(self) -> dict:
        return self.manifest.get("meta", {})

    def client_keys(self, cid: int) -> list[str]:
        return sorted(self.manifest["clients"][cid]["keys"])

    def rows(self, cid: int, key: str) -> int:
        ent = self.manifest["clients"][cid]["keys"].get(key)
        return 0 if ent is None else int(ent["shape"][0])

    def fingerprint(self) -> str:
        """Stable identity of this store's contents: sha256 over the
        canonical manifest JSON (shapes, dtypes, per-shard checksums)."""
        blob = json.dumps(self.manifest, sort_keys=True,
                          separators=(",", ":")).encode()
        return hashlib.sha256(blob).hexdigest()

    # ---- shard reads ----

    def shard(self, cid: int, key: str) -> ShardRows:
        ent = self.manifest["clients"][cid]["keys"][key]
        path = os.path.join(self.store_dir, _client_dirname(cid), key + ".npy")
        return ShardRows(path, tuple(ent["shape"]), np.dtype(ent["dtype"]))

    def client(self, cid: int) -> ClientView:
        return ClientView(self, cid)

    def clients(self) -> list[ClientView]:
        return [self.client(c) for c in range(self.n_clients)]

    def val(self) -> dict:
        """Materialize the replicated server validation set."""
        out = {}
        for key, ent in self.manifest["val"].items():
            path = os.path.join(self.store_dir, "val", key + ".npy")
            out[key] = ShardRows(path, tuple(ent["shape"]),
                                 np.dtype(ent["dtype"])).read()
        return out

    def rows_for_clients(self, ids, rows) -> dict:
        """Multi-host seam: read specific row subsets of specific clients.

        Parameters
        ----------
        ids : sequence of client indices (e.g. this mesh slice's share of
            the round's sampled clients).
        rows : mapping ``key -> sequence of per-id row-index arrays``
            (``rows[key][j]`` selects rows of client ``ids[j]``'s ``key``
            shard; ``None`` selects no rows).

        Returns ``key -> list of materialized arrays``, aligned with
        ``ids``. Only the named clients' shard files are opened, so a
        host holding a slice of the store on local disk serves its slice
        of the round without touching any other host's data.
        """
        out = {}
        for key, sels in rows.items():
            if len(sels) != len(ids):
                raise ValueError(
                    f"rows[{key!r}] has {len(sels)} selections for "
                    f"{len(ids)} client ids")
            got = []
            for cid, sel in zip(ids, sels):
                if sel is None:
                    got.append(None)
                elif key not in self.manifest["clients"][cid]["keys"]:
                    raise KeyError(f"client {cid} holds no {key!r} shard")
                else:
                    got.append(self.shard(cid, key)[np.asarray(sel)])
            out[key] = got
        return out


def write_store(store_dir: str, clients: list, val: dict, *,
                meta: dict | None = None, overwrite: bool = False) -> ClientStore:
    """Write C in-memory client datasets (+ the server val set) to a
    store directory, atomically (staged in ``<store_dir>.tmp`` and
    renamed into place). Returns the opened :class:`ClientStore`.

    ``clients`` is the ``FederatedBatcher`` dict-of-arrays format; keys
    whose value is ``None`` are dropped, zero-row arrays keep a manifest
    entry (shape/dtype) so the ragged-ness survives the round-trip.
    """
    store_dir = str(store_dir)
    if os.path.exists(store_dir):
        if not overwrite:
            raise FileExistsError(
                f"{store_dir!r} exists (pass overwrite=True to replace)")
    missing = [k for k in _VAL_KEYS if k not in val]
    if missing:
        raise KeyError(f"val set missing {missing}")

    tmp = store_dir.rstrip("/") + ".tmp"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"version": STORE_VERSION, "n_clients": len(clients),
                "clients": [], "val": {}, "meta": meta or {}}

    def _write(dirname: str, key: str, arr: np.ndarray) -> dict:
        arr = np.ascontiguousarray(arr)
        np.save(os.path.join(tmp, dirname, key + ".npy"), arr)
        return {"shape": list(arr.shape), "dtype": str(arr.dtype),
                "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}

    os.makedirs(os.path.join(tmp, "val"))
    for key in _VAL_KEYS:
        manifest["val"][key] = _write("val", key, np.asarray(val[key]))
    for cid, ds in enumerate(clients):
        dirname = _client_dirname(cid)
        os.makedirs(os.path.join(tmp, dirname))
        ent = {"keys": {}}
        for key in sorted(ds.keys()):
            v = ds[key]
            if v is None:
                continue
            ent["keys"][key] = _write(dirname, key, np.asarray(v))
        manifest["clients"].append(ent)
    with open(os.path.join(tmp, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)

    # overwrite via swap, never delete-before-rename: the old store moves
    # aside as .old (which ClientStore treats as a readable fallback),
    # the new one renames into place, only then is the old data removed —
    # a complete copy stays findable at every instant
    old = store_dir.rstrip("/") + ".old"
    if os.path.exists(store_dir):
        if os.path.isdir(old):
            shutil.rmtree(old)
        os.rename(store_dir, old)
    os.rename(tmp, store_dir)
    shutil.rmtree(old, ignore_errors=True)  # also sweeps a stale crash .old
    return ClientStore(store_dir)
