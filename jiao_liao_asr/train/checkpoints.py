"""Checkpointing: flat npz of the path-keyed tree, safetensors import/export.

Reference mechanisms (SURVEY.md §5.4): safetensors weights + HF hub layout,
accelerate/SB checkpointer for optimizer/scheduler/RNG. Here: a checkpoint
is one .npz holding every leaf of {params, opt_state, PRNG key, step} under
its "/"-joined tree path, written to a temporary file and renamed into
place, plus a data-iterator state in extra.json, so a restarted job resumes
exactly; a small adapter-only artifact mirrors the reference's tiny
per-dialect adapter checkpoints; and a pure-numpy safetensors reader/writer
(utils side) imports reference Whisper weights (SURVEY N11).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from pathlib import Path
from typing import Any, Dict, Optional

import jax
import numpy as np


def _ckpt_dir(path: str) -> Path:
    p = Path(path).resolve()
    p.mkdir(parents=True, exist_ok=True)
    return p


def path_key(kpath) -> str:
    """"/"-joined names of a tree path (dict keys, sequence indices and
    attribute names alike)."""
    return "/".join(
        str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))
        for k in kpath
    )


def _host_value(leaf) -> np.ndarray:
    if isinstance(leaf, jax.Array) and not leaf.is_fully_addressable:
        # a global array spread over several processes: every process
        # gathers the full value (a collective), the primary writes it
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(leaf, tiled=True))
    return np.asarray(leaf)


def save_tree(path: Path, tree: Any) -> None:
    """Write every leaf of `tree` under its path key into one .npz, through
    a temporary file renamed into place (a crash never leaves a torn file).
    Multi-host: every process must call this (the gather is a collective);
    only the primary writes."""
    from ..parallel import multihost as mh

    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    arrays = {path_key(kp): _host_value(leaf) for kp, leaf in flat}
    if not mh.is_primary():
        return
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def restore_tree(path: Path, template: Any) -> Any:
    """Read a save_tree file into the structure of `template`. Each leaf
    takes the template leaf's dtype and, for a jax.Array, its sharding
    (each process places only its addressable shards)."""
    with np.load(path) as data:
        stored = {k: data[k] for k in data.files}

    def _leaf(kp, tmpl):
        key = path_key(kp)
        if key not in stored:
            raise KeyError(f"{path}: no entry {key!r}")
        arr = stored[key]
        want = np.dtype(getattr(tmpl, "dtype", arr.dtype))
        if arr.dtype != want:
            # np.savez stores extension dtypes (bfloat16) as raw bytes
            arr = arr.view(want) if arr.dtype.kind == "V" else arr.astype(want)
        if tuple(arr.shape) != tuple(np.shape(tmpl)):
            raise ValueError(
                f"{path}: {key!r} has shape {arr.shape}, expected {np.shape(tmpl)}"
            )
        if isinstance(tmpl, jax.Array):
            return jax.make_array_from_callback(
                arr.shape, tmpl.sharding, lambda idx: arr[idx]
            )
        return arr

    return jax.tree_util.tree_map_with_path(_leaf, template)


def save_params(path: str, params: Any) -> None:
    """Save a param pytree as <path>/params.npz."""
    save_tree(_ckpt_dir(path) / "params.npz", params)


def restore_params(path: str, template: Any) -> Any:
    return restore_tree(Path(path).resolve() / "params.npz", template)


class TrainCheckpointer:
    """Step-indexed train-state checkpoints with retention + exact resume.

    Layout: <dir>/<step>/state.npz and <dir>/<step>/extra.json
    (data-iterator state + metadata, host-side).
    """

    def __init__(self, directory: str, keep: int = 3):
        self.dir = _ckpt_dir(directory)
        self.keep = keep

    def save(self, step: int, state: Any, extra: Optional[Dict] = None) -> None:
        """Save one step. Multi-host: every process joins the gather, the
        primary writes the files and runs retention gc, fenced by barriers
        so no host reads a dir mid-delete."""
        from ..parallel import multihost as mh

        d = self.dir / f"{step:08d}"
        save_tree(d / "state.npz", state)
        mh.barrier("ckpt_save")
        if mh.is_primary():
            (d / "extra.json").write_text(json.dumps(extra or {}))
            self._gc()
        mh.barrier("ckpt_gc")

    def _steps(self):
        return sorted(
            int(p.name) for p in self.dir.iterdir()
            if p.is_dir() and p.name.isdigit() and (p / "state.npz").exists()
        )

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None):
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None, None
        d = self.dir / f"{step:08d}"
        state = restore_tree(d / "state.npz", template)
        extra = json.loads((d / "extra.json").read_text()) if (d / "extra.json").exists() else {}
        return step, state, extra

    def _gc(self) -> None:
        for s in self._steps()[: -self.keep]:
            shutil.rmtree(self.dir / f"{s:08d}", ignore_errors=True)


def save_adapter_only(path: str, params: Any) -> None:
    """Write the tiny adapter-only artifact (flattened npz): the reference's
    per-dialect adapter checkpoint equivalent (SURVEY §5.4)."""
    from ..models.adapters import param_is_adapter

    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    out = {}
    for kpath, leaf in flat:
        keys = tuple(getattr(k, "key", getattr(k, "idx", str(k))) for k in kpath)
        if param_is_adapter(keys):
            out[path_key(kpath)] = np.asarray(leaf)
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    np.savez(p, **out)


def load_adapter_only(path: str, params: Any) -> Any:
    """Merge an adapter-only npz back into a full param tree."""
    with np.load(path) as data:
        updates = {k: data[k] for k in data.files}

    def _replace(kpath, leaf):
        return updates.get(path_key(kpath), leaf)

    return jax.tree_util.tree_map_with_path(_replace, params)
