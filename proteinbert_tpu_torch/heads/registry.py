"""Versioned on-disk registry of finetuned task heads — a copy of
`proteinbert_tpu/heads/registry.py` (jax-free; the port never imports the
JAX package), with `trunk_fingerprint` reading the port's tensors.

Only the HEAD is per-task: a linear or MLP layer over the shared trunk's
representation. This registry is the store that connects fine-tuning
(`train/finetune.finetune(..., registry=)`) with serving
(`serve/server.Server(registry=)`):

- **content-addressed**: a head's id is a digest over its parameter
  bytes, its TaskConfig and the fingerprint of the trunk it was trained
  against;
- **self-verifying**: `meta.json` records the parameter digest and every
  `load()` recomputes it, so a corrupted artifact raises
  `CorruptHeadError`;
- **trunk-compatible by contract**: loading against a resident trunk
  whose fingerprint differs raises `TrunkMismatchError`.

The format on disk is the JAX package's, so a head saved by either
package loads in the other (`<registry>/<head_id>/head.npz` of
slash-joined paths, `meta.json` with `config_to_dict(task)` and the
trunk fingerprint). `trunk_fingerprint` hashes the trunk as the JAX
package lays it out: with `scan_blocks` (the default of
`ModelConfig.scan_blocks`) the blocks are stacked, `blocks/<leaf>` with a
leading num_blocks axis; without, `blocks/<i>/<leaf>`. So the port's
trunk and the same weights in the JAX package give one digest. Writes are
atomic (temporary directory + rename). Artifacts load as numpy; placing
them on the device is the serving layer's job
(serve/dispatch.BucketDispatcher.add_head).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import shutil
import tempfile
import time
import zipfile
from typing import Any, Dict, List, Optional

import numpy as np

import torch

from proteinbert_tpu_torch.configs import TaskConfig
from proteinbert_tpu_torch.configs.config import (
    config_from_dict, config_to_dict,
)

logger = logging.getLogger(__name__)

FORMAT_VERSION = 1

# Pretraining output heads are NOT part of the trunk: a finetune trunk
# (models/finetune.init drops them) and the pretrain params it came
# from must fingerprint identically.
_PRETRAIN_HEAD_KEYS = ("local_head", "global_head")


class HeadRegistryError(Exception):
    """Base class for registry failures."""


class UnknownHeadError(HeadRegistryError, LookupError):
    """No artifact with this head id (the serving layer maps this to a
    typed 404)."""


class CorruptHeadError(HeadRegistryError, ValueError):
    """An artifact's bytes do not match its recorded digest (or its
    metadata is unreadable) — refuse to serve it."""


class TrunkMismatchError(HeadRegistryError, ValueError):
    """The head was trained against a different trunk than the resident
    one; applying it would silently produce garbage."""


class UnfrozenHeadError(HeadRegistryError, ValueError):
    """`migrate_fingerprint` was asked to re-pin a head that was trained
    with `freeze_trunk=False`: its weights co-adapted to the exact trunk
    it trained with, so pinning them to a DIFFERENT trunk would be a
    silent quality lie — the typed refusal of the rollout head-migration
    contract. Re-finetune against the new trunk instead."""


def _host(leaf) -> np.ndarray:
    """A leaf as a host array (a tensor leaves its device)."""
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree: Any, path: tuple = ()) -> Dict[str, np.ndarray]:
    """Tree of arrays or tensors → {"out/kernel": np.ndarray, ...}
    (sorted keys, dtypes kept) — the flat-NPZ idiom of export.py."""
    flat: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            flat.update(_flatten(tree[k], path + (str(k),)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flat.update(_flatten(v, path + (str(i),)))
    else:
        flat["/".join(path)] = _host(tree)
    return flat


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, arr in flat.items():
        node = tree
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = arr
    return tree


def _digest(flat: Dict[str, np.ndarray]) -> str:
    """sha256 over (path, shape, dtype, raw bytes) of every leaf in
    sorted path order — the content identity of a parameter tree,
    independent of NPZ container bytes (zip timestamps vary)."""
    h = hashlib.sha256()
    for path in sorted(flat):
        a = np.ascontiguousarray(flat[path])
        h.update(path.encode())
        h.update(repr((a.shape, str(a.dtype))).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def trunk_fingerprint(params: Any, scan_blocks: bool = True) -> str:
    """Content fingerprint of a trunk parameter tree: the JAX package's
    digest of the same weights.

    Accepts pretrain params (their `local_head` / `global_head` are
    dropped: `encode_trunk` does not read them) or a stripped fine-tune
    trunk; both hash alike. A port trunk's `blocks` list is laid out as
    the JAX package's tree with `scan_blocks` (ModelConfig.scan_blocks):
    stacked into `blocks/<leaf>` with a leading num_blocks axis, or
    `blocks/<i>/<leaf>`; a `blocks` dict (an already stacked tree) is
    hashed as it is. One device → host copy of the trunk per call —
    compute it once and keep it (the Server does)."""
    if isinstance(params, dict):
        params = {k: v for k, v in params.items()
                  if k not in _PRETRAIN_HEAD_KEYS}
        blocks = params.get("blocks")
        if isinstance(blocks, (list, tuple)) and scan_blocks:
            per_block = [_flatten(b) for b in blocks]
            params = {**params, "blocks": _unflatten(
                {k: np.stack([f[k] for f in per_block])
                 for k in per_block[0]})}
    return _digest(_flatten(params))


@dataclasses.dataclass
class LoadedHead:
    """One registered head, materialized for use: parameter pytree +
    the TaskConfig it was trained with + its metadata record."""

    head_id: str
    name: str
    task: TaskConfig
    params: Dict[str, Any]
    meta: Dict[str, Any]

    @property
    def kind(self) -> str:
        return self.task.kind


class HeadRegistry:
    """Directory-backed head artifact store (see module doc)."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    # ------------------------------------------------------------- paths

    def _dir(self, head_id: str) -> str:
        if not head_id or "/" in head_id or head_id.startswith("."):
            raise UnknownHeadError(f"malformed head id {head_id!r}")
        return os.path.join(self.directory, head_id)

    # -------------------------------------------------------------- save

    def save(
        self,
        head_params: Any,
        task: TaskConfig,
        trunk_fp: str,
        *,
        name: Optional[str] = None,
        metrics: Optional[Dict[str, float]] = None,
        model: Optional[Dict[str, Any]] = None,
    ) -> str:
        """Register one head; returns its content-addressed id.

        Saving identical (params, task, trunk) twice is idempotent —
        the second save atomically replaces an identical artifact.
        `metrics` records the finetune's eval numbers beside the
        weights (the eval harness and `pbt eval-heads` append fresh
        ones); `model` optionally records the trunk geometry the head's
        input dims came from (purely informational — compatibility is
        enforced by the trunk fingerprint, not by geometry fields).
        """
        flat = _flatten(head_params)
        if not flat:
            raise HeadRegistryError("empty head parameter tree")
        head_digest = _digest(flat)
        task_dict = config_to_dict(task)
        h = hashlib.sha256()
        h.update(head_digest.encode())
        h.update(json.dumps(task_dict, sort_keys=True).encode())
        h.update(str(trunk_fp).encode())
        head_id = h.hexdigest()[:16]
        meta = {
            "format_version": FORMAT_VERSION,
            "head_id": head_id,
            "name": name or head_id,
            "kind": task.kind,
            "task": task_dict,
            "model": model or {},
            "trunk_fingerprint": str(trunk_fp),
            "head_digest": head_digest,
            "metrics": dict(metrics or {}),
            "created_at": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        }
        tmp = tempfile.mkdtemp(prefix=f".{head_id}.tmp.",
                               dir=self.directory)
        try:
            np.savez(os.path.join(tmp, "head.npz"), **flat)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f, indent=2, sort_keys=True)
            final = self._dir(head_id)
            if os.path.isdir(final):  # idempotent re-register
                old = final + f".old.{os.getpid()}"
                os.rename(final, old)
                os.rename(tmp, final)
                shutil.rmtree(old, ignore_errors=True)
            else:
                os.rename(tmp, final)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        return head_id

    # -------------------------------------------------------------- load

    def _read_meta(self, head_id: str) -> Dict[str, Any]:
        d = self._dir(head_id)
        path = os.path.join(d, "meta.json")
        if not os.path.isdir(d) or not os.path.isfile(path):
            raise UnknownHeadError(
                f"no head {head_id!r} in registry {self.directory}")
        try:
            with open(path) as f:
                meta = json.load(f)
        except (OSError, ValueError) as e:
            raise CorruptHeadError(
                f"head {head_id}: unreadable meta.json ({e})") from None
        for field in ("format_version", "head_id", "task", "head_digest",
                      "trunk_fingerprint"):
            if field not in meta:
                raise CorruptHeadError(
                    f"head {head_id}: meta.json missing {field!r}")
        if meta["format_version"] > FORMAT_VERSION:
            raise CorruptHeadError(
                f"head {head_id}: format_version {meta['format_version']} "
                f"is newer than this build understands ({FORMAT_VERSION})")
        if meta["head_id"] != head_id:
            raise CorruptHeadError(
                f"head {head_id}: meta.json claims id {meta['head_id']!r}")
        return meta

    def load(self, head_id: str,
             trunk_fp: Optional[str] = None) -> LoadedHead:
        """Load + verify one head. With `trunk_fp` (the resident trunk's
        fingerprint), a trained-against-a-different-trunk artifact
        raises TrunkMismatchError BEFORE any weights are returned."""
        meta = self._read_meta(head_id)
        if trunk_fp is not None and meta["trunk_fingerprint"] != trunk_fp:
            raise TrunkMismatchError(
                f"head {head_id} ({meta.get('name')}) was trained against "
                f"trunk {meta['trunk_fingerprint'][:12]}…, but the resident "
                f"trunk fingerprints as {str(trunk_fp)[:12]}… — applying it "
                "would silently produce garbage. Re-finetune against this "
                "trunk (freeze_trunk keeps the fingerprint stable), or "
                "serve the trunk this head was trained with.")
        npz_path = os.path.join(self._dir(head_id), "head.npz")
        try:
            with np.load(npz_path) as z:
                flat = {k: np.array(z[k]) for k in z.files}
        except (OSError, ValueError, KeyError,
                zipfile.BadZipFile) as e:
            raise CorruptHeadError(
                f"head {head_id}: unreadable head.npz ({e})") from None
        got = _digest(flat)
        if got != meta["head_digest"]:
            raise CorruptHeadError(
                f"head {head_id}: parameter digest {got[:12]}… does not "
                f"match the recorded {meta['head_digest'][:12]}… — the "
                "artifact is corrupted; refusing to serve it")
        task = config_from_dict(meta["task"], TaskConfig)
        return LoadedHead(head_id=head_id, name=meta.get("name", head_id),
                          task=task, params=_unflatten(flat), meta=meta)

    # ----------------------------------------------------------- migrate

    def migrate_fingerprint(self, head_id: str, new_trunk_fp: str,
                            note: Optional[str] = None) -> Dict[str, Any]:
        """Re-pin one registered head to a new trunk fingerprint
        (blue-green rollout promotion) with an audit trail.

        Only FROZEN-trunk heads migrate: a head trained with
        `freeze_trunk=True` is a function of the trunk's OUTPUT SPACE,
        and the rollout gate (`heads_eval_score_min` delta through the
        candidate trunk) has measured that space before any promotion;
        an unfrozen head co-adapted to its exact trunk and gets the
        typed `UnfrozenHeadError` instead. The rewrite is in-place and
        atomic (tmp file + os.replace), keeps the head_id (the
        directory name stays the content address of the ORIGINAL
        registration — `_read_meta` checks identity against the
        directory, and `load()` verifies weights by digest, so an
        artifact can never silently point at different weights), and
        appends one {from, to, at, note} record to `meta["migrations"]`.
        Returns the updated meta. Idempotent when already pinned to
        `new_trunk_fp`."""
        meta = self._read_meta(head_id)
        task = config_from_dict(meta["task"], TaskConfig)
        if not task.freeze_trunk:
            raise UnfrozenHeadError(
                f"head {head_id} ({meta.get('name')}) was trained with "
                "freeze_trunk=False — its weights co-adapted to trunk "
                f"{meta['trunk_fingerprint'][:12]}… and cannot be "
                "re-pinned to a different trunk; re-finetune it against "
                "the new trunk instead")
        old_fp = meta["trunk_fingerprint"]
        if old_fp == str(new_trunk_fp):
            return meta
        meta["trunk_fingerprint"] = str(new_trunk_fp)
        meta.setdefault("migrations", []).append({
            "from": old_fp,
            "to": str(new_trunk_fp),
            "at": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
            "note": note or "",
        })
        path = os.path.join(self._dir(head_id), "meta.json")
        tmp = path + f".tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=2, sort_keys=True)
        os.replace(tmp, path)
        return meta

    def verify(self, head_id: str) -> Dict[str, Any]:
        """Full integrity check (meta readable + digest matches);
        returns the meta record. Raises UnknownHeadError /
        CorruptHeadError like load()."""
        return self.load(head_id).meta

    # -------------------------------------------------------------- list

    def list_heads(self) -> List[Dict[str, Any]]:
        """Metadata of every well-formed artifact, oldest first.
        Malformed entries are skipped with a warning (listing must work
        on an imperfect store; load() is where corruption is typed)."""
        out = []
        for entry in sorted(os.listdir(self.directory)):
            if entry.startswith("."):
                continue
            try:
                out.append(self._read_meta(entry))
            except (UnknownHeadError, CorruptHeadError) as e:
                logger.warning("skipping registry entry %s: %s", entry, e)
        out.sort(key=lambda m: (m.get("created_at") or "", m["head_id"]))
        return out

    def __contains__(self, head_id: str) -> bool:
        try:
            self._read_meta(head_id)
            return True
        except HeadRegistryError:
            return False
