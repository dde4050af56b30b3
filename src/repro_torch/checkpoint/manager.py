"""Checkpoints in the reference's format (``repro/checkpoint/manager.py``).

A checkpoint is a directory ``step_<N:010d>/`` holding one ``<group>.npz``
per top-level state group and a ``MANIFEST.json``: ``{"step": N,
"groups": {group: [path, ...]}}``, where the i-th path names the array
stored under key ``a{i}`` of the group's npz. Writes go to
``step_<N>.tmp/``, are fsynced and then renamed (a crash mid-save never
corrupts the latest valid checkpoint); an optional background thread
makes saves asynchronous; the ``keep`` most recent checkpoints are kept.

The files are the reference's files:

  * paths: ``/``-joined dict keys in sorted order; a VQWeight is a
    ``__vq__`` node holding ``idx``, ``codebooks``, ``scale`` and
    ``__vqmeta__ = [K, N, d, n, *splits]``; a list or tuple item is
    ``__seq__<i>``; None is a ``__none__`` path with no array;
  * layout: the reference scans its layers, so on disk a ``"layers"``
    (or ``"pre_layers"``, the xLSTM, RecurrentGemma and Vision
    ``"groups"``, RecurrentGemma's ``"trail"``, or Whisper's ``"encoder"``
    and ``"decoder"``) node is one node whose leaves are stacked on a
    leading L axis (a scalar, Vision's gates, becomes an (L,) array). The
    port holds a list of per-layer dicts: ``save`` stacks it
    (``convert.to_reference_layout``), ``restore`` unstacks it
    (``convert.from_jax_params``); a tensor the layers share (the KV-VQ
    codebooks) is written stacked, L copies, as the reference holds it;
  * dtypes: each leaf's own (fp32, uint8, int32, int64 metadata ...).
    **bf16 leaves** are written as the reference writes them: the
    reference's ``np.asarray`` of a bf16 array is an ``ml_dtypes`` array,
    which numpy stores as the raw 2-byte void ``'<V2'`` with no dtype in
    the manifest. ``torch.Tensor.numpy()`` refuses bf16 and the port
    does not need ``ml_dtypes``, so the port writes the tensor's bits
    under the same ``'<V2'`` header (same bytes), and reads every 2-byte
    void leaf back as bfloat16 bits. (The reference's own ``restore``
    cannot read such a leaf: ``jnp.asarray`` refuses ``V2``.)

Optimizer state is the reference's ``__adamw__`` node: an
``optim.AdamWState`` is written under ``.../__adamw__/{step,m,v,master}``
(``m``, ``v`` and ``master`` in the stacked layout, ``master`` a
``__none__`` path when absent) and read back as one. A VQ-Logits head
(a ``vql`` node) has no layout on disk: the reference pickles it as one
object leaf that its own ``restore`` refuses, so ``save`` raises on it,
naming the node.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import DeviceLike, resolve_device
from repro_torch.convert import from_jax_params, is_vq, to_reference_layout
from repro_torch.core.logits_vq import VQLogitsHead
from repro_torch.core.vq import VQWeight
from repro_torch.optim.adamw import AdamWState

_SENTINEL_NONE = "__none__"
_BF16 = np.dtype("V2")      # how numpy holds a bf16 leaf without ml_dtypes


# --------------------------------------------------------------- pytree io


def flatten_with_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs of ``tree`` in the reference's grammar (see
    module docstring); leaves are returned as they are."""
    out: List[Tuple[str, Any]] = []
    if isinstance(tree, dict):
        for k in sorted(tree.keys()):
            out += flatten_with_paths(tree[k], f"{prefix}/{k}")
    elif is_vq(tree):
        out += flatten_with_paths(
            {"idx": tree.idx, "codebooks": tree.codebooks, "scale": tree.scale,
             "__vqmeta__": np.asarray(
                 [tree.K, tree.N, tree.d, tree.n, *tree.splits])},
            f"{prefix}/__vq__")
    elif isinstance(tree, AdamWState):
        out += flatten_with_paths(
            {"step": tree.step, "m": tree.m, "v": tree.v,
             "master": (tree.master if tree.master is not None
                        else _SENTINEL_NONE)},
            f"{prefix}/__adamw__")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out += flatten_with_paths(v, f"{prefix}/__seq__{i}")
    elif tree is None or (isinstance(tree, str) and tree == _SENTINEL_NONE):
        out.append((f"{prefix}/__none__", None))
    else:
        out.append((prefix, tree))
    return out


def unflatten_from_paths(flat: Dict[str, Any]) -> Any:
    """Rebuild the nested structure from path -> leaf: dicts, VQWeight
    nodes (the port's), ``AdamWState`` for ``__adamw__`` nodes, tuples
    for ``__seq__`` nodes, None."""
    root: Dict[str, Any] = {}
    for path, leaf in flat.items():
        parts = [p for p in path.split("/") if p]
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf

    def rebuild(node):
        if not isinstance(node, dict):
            return node
        if "__none__" in node:
            return None
        if "__vq__" in node:
            sub = node["__vq__"]
            meta = np.asarray(sub["__vqmeta__"]).astype(int)
            return VQWeight(idx=sub["idx"], codebooks=sub["codebooks"],
                            scale=sub["scale"], K=int(meta[0]), N=int(meta[1]),
                            d=int(meta[2]), n=int(meta[3]),
                            splits=tuple(int(s) for s in meta[4:]))
        if "__adamw__" in node:
            sub = node["__adamw__"]
            return AdamWState(step=sub["step"], m=rebuild(sub["m"]),
                              v=rebuild(sub["v"]),
                              master=rebuild(sub["master"]))
        if any(k.startswith("__seq__") for k in node):
            items = sorted(node.items(), key=lambda kv: int(kv[0][7:]))
            return tuple(rebuild(v) for _, v in items)
        return {k: rebuild(v) for k, v in node.items()}

    return rebuild(root)


def to_host(x: Any) -> Any:
    """A leaf as the numpy array the reference writes: a tensor's values
    on the host, bf16 as its bits in a 2-byte void array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", copy=True).contiguous()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(_BF16)
        return x.numpy()
    return x


def _has_dtensor(tree: Any) -> bool:
    from torch.distributed.tensor import DTensor
    from repro_torch.runtime import tensor_parallel as tp

    found: List[bool] = []
    tp.map_tensors(lambda x: found.append(isinstance(x, DTensor)) or x, tree)
    return any(found)


def _host_snapshot(tree: Any, path: str = "") -> Any:
    """Every tensor of ``tree`` copied to the host.

    Raises:
      NotImplementedError: a VQ-Logits head (module docstring), named by
        its path."""
    if isinstance(tree, VQLogitsHead):
        raise NotImplementedError(
            f"{path}: a VQ-Logits head (a 'vql' node) has no checkpoint "
            "layout (the reference pickles it into a file its own restore "
            "refuses); save the dense head (core.logits_vq.expand) instead")
    if is_vq(tree):
        return VQWeight(idx=to_host(tree.idx),
                        codebooks=to_host(tree.codebooks),
                        scale=to_host(tree.scale), K=tree.K, N=tree.N,
                        d=tree.d, n=tree.n, splits=tuple(tree.splits))
    if isinstance(tree, dict):
        return {k: _host_snapshot(v, f"{path}/{k}") for k, v in tree.items()}
    if isinstance(tree, AdamWState):
        return AdamWState(*(_host_snapshot(v, f"{path}/{f}")
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_snapshot(v, f"{path}/{i}")
                          for i, v in enumerate(tree))
    return to_host(tree)


def from_host(a: np.ndarray) -> torch.Tensor:
    """A host array (read from a checkpoint, or an engine snapshot's) as a
    CPU tensor over the same memory (2-byte void: bfloat16 bits)."""
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _write_npz(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """``np.savez(path, **arrays)``, member for member: an uncompressed
    zip64 archive of ``<key>.npy`` files, each written by numpy except a
    bf16 leaf, whose header carries the reference's ``'<V2'``."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, val in arrays.items():
            val = np.asanyarray(val)
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                if val.dtype == _BF16:
                    header = np.lib.format.header_data_from_array_1_0(val)
                    header["descr"] = "<V2"
                    np.lib.format.write_array_header_1_0(fid, header)
                    fid.write(np.ascontiguousarray(val).tobytes())
                else:
                    np.lib.format.write_array(fid, val, allow_pickle=False)


def _fsync(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


# ----------------------------------------------------------------- manager


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep: int = 3
    async_save: bool = False

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._last_error: Optional[Exception] = None

    # ---- paths
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.directory, name,
                                               "MANIFEST.json")):
                    out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ---- save
    def _write(self, step: int, state: Dict[str, Any]):
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "groups": {}}
        for group, tree in state.items():
            paths, arrays = [], {}
            for i, (path, leaf) in enumerate(flatten_with_paths(tree)):
                paths.append(path)
                if leaf is not None:
                    arrays[f"a{i}"] = np.asarray(leaf)
            npz = os.path.join(tmp, f"{group}.npz")
            _write_npz(npz, arrays)
            _fsync(npz)
            manifest["groups"][group] = paths
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def save(self, step: int, state: Dict[str, Any], *, block: bool = False):
        """state: {"params": ..., "opt": ..., "extra": ...}, the port's
        trees (``"opt"`` an ``optim.AdamWState``). Every
        tensor is copied to the host (and the layers stacked) before the
        async thread starts, so the caller may go on changing them.

        A state holding DTensors (params sharded over a mesh's ``model``
        axis) is written whole, the same files whatever mesh holds it:
        every rank of the process group calls ``save`` (the shards are
        gathered), and only rank 0 writes."""
        if _has_dtensor(state):
            from repro_torch.runtime import tensor_parallel as tp

            state = {g: tp.full(v) for g, v in state.items()}
            if dist.get_rank() != 0:
                return
        host_state = {g: to_reference_layout(_host_snapshot(state[g],
                                                            f"/{g}"))
                      for g in sorted(state)}  # the reference's tree_map sorts
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._last_error is not None:
            raise self._last_error
        if self.async_save and not block:
            def run():
                try:
                    self._write(step, host_state)
                except Exception as e:  # pragma: no cover
                    self._last_error = e
            self._thread = threading.Thread(target=run, daemon=True)
            self._thread.start()
        else:
            self._write(step, host_state)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._last_error is not None:
            raise self._last_error

    # ---- restore
    def restore(self, step: Optional[int] = None, *,
                device: DeviceLike = None,
                unstack: bool = True) -> Tuple[int, Dict[str, Any]]:
        """(step, state) of ``step`` (default: the latest), each group a
        tree in the port's layout (per-layer lists; ``unstack=False``:
        nested as on disk) on ``device`` (default "cuda").

        Raises:
          FileNotFoundError: no checkpoint in the directory.
        """
        dev = resolve_device(device)
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = self._step_dir(step)
        with open(os.path.join(d, "MANIFEST.json")) as f:
            manifest = json.load(f)
        state = {}
        for group, paths in manifest["groups"].items():
            with np.load(os.path.join(d, f"{group}.npz")) as data:
                flat = {path: (None if path.endswith("/__none__")
                               else from_host(data[f"a{i}"]))
                        for i, path in enumerate(paths)}
            state[group] = from_jax_params(unflatten_from_paths(flat),
                                           device=dev, unstack=unstack)
        return step, state
