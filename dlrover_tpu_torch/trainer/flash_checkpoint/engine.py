"""Flash checkpoint engine (trainer side): train state <-> shm <-> storage.
Counterpart of dlrover_tpu/trainer/flash_checkpoint/engine.py (reference
dlrover/trainer/torch/flash_checkpoint/engine.py:136 `CheckpointEngine`,
checkpointer.py:23 `Checkpointer`).

The state is the port's train state (`parallel/accelerate.py`):
`{"params": nested dict of tensors, "opt_state": torch.optim.Optimizer,
"step": int[, "loss_scale": LossScaleState]}`. `flatten_state` gives it
the path keys that JAX's `flatten_state` gives the equivalent JAX state
(`params/layers/wq`, `opt_state/0/mu/layers/wq`, `opt_state/0/count`,
`step`, ...), so the staged segment and `host_<rank>.npz` hold the same
keys and arrays in both packages. Optimizer state maps to optax's
layout: torch's Adam / AdamW `exp_avg` / `exp_avg_sq` / `step` to
`mu` / `nu` / `count` (zeros and 0 before the first step, where torch
has no state yet); the port's chain optimizers (`optim/`) keep optax's
own state names, each under `opt_state/0/<name>/<param path>` with
their `count`; `lora_optimizer`'s state (adapter leaves only) goes
under `opt_state/inner_states/lora/inner_state/0/...`, where optax's
`multi_transform` files it. Any other tree of tensors (an adapter-only
sub-tree) is saved as its leaves by path. numpy has no bfloat16: a bf16 leaf is staged as its
16-bit pattern (uint16), its dtype kept in `aux`, the port's own plain
description of the leaves (paths, shapes, dtype names; never a JAX
treedef).

Saving is asynchronous (`save_to_memory_async`): the trainer blocks only
to copy the state into a snapshot on its device (the next optimizer
step overwrites params and moments in place, so the staged bytes must
be a copy of the saved step's), and a staging thread copies the
snapshot into the shm segment on its own CUDA stream, straight into
the page-locked segment. The snapshot buffers are allocated once and
reused (one state's bytes on the card from the first save to `close`),
and `prepare` allocates them and page-locks the segment ahead of the
first save: page-locking ~23 GB takes seconds and holds the CUDA
driver, so it belongs before the training loop, not inside a step.
Restoring writes in place into a target state's tensors and loads the
optimizer state keyed by the target's own param objects (the optimizer
holds references to them), memory first, storage when shm is older or
torn. With no agent on the host the engine runs the IPC server and the
saver in-process (`local_saver`).

With a `replica_manager` (`replica.CkptReplicaManager`) each staging is
also shipped to the job master's KV store in the background, as in
JAX: best-effort, one backup in flight and the newest parked behind it;
a restore with an empty shm takes the replica before storage when it
is at least as fresh.

A state in fsdp pieces (its "layout" a `ShardPlan` that splits leaves,
parallel/accelerate.py) is staged as this rank's pieces, JAX's way: a
split leaf (and each moment of it) under `<path>#shard{rank}_0`, with
JAX's `shards` table in the aux ({path: shape, dtype, keys, indices},
the indices as [start, stop] per dim), so each rank's segment holds its
own bytes only. A restore takes a piece straight from the key of this
rank where its slice is the one the target holds (memory, same layout),
else cuts it from the whole leaf; storage stitches the whole leaf from
every host's files where the shard tables cover it (`_stitch_shards`;
also a JAX checkpoint written by several processes), so a state saved
in one layout loads onto any other. A memory segment that lacks a
needed piece raises KeyError, and `load` falls back to storage.
"""

import contextlib
import io
import os
import pickle
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_flatten_with_path

from dlrover_tpu_torch._device import DeviceLike, resolve_device
from dlrover_tpu_torch.agent.ckpt_saver import (
    CKPT_QUEUE_NAME,
    RESTORE_THREADS,
    STOP_EVENT,
    AsyncCheckpointSaver,
    SharedMemoryHandler,
    ShmIntegrityError,
    layout,
    pread_full,
    read_tracker_step,
)
from dlrover_tpu_torch.common.constants import CheckpointConstant, NodeEnv
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.multi_process import (
    LocalSocketServer,
    SharedQueue,
    server_alive,
)
from dlrover_tpu_torch.common.storage import (
    CheckpointStorage,
    get_checkpoint_storage,
)
from dlrover_tpu_torch.optim._chain import ChainOptimizer
from dlrover_tpu_torch.optim.mup import path_str
from dlrover_tpu_torch.parallel.amp import LossScaleState

AUX_FORMAT = "dlrover_tpu_torch/flat-v1"
_ADAM = (torch.optim.Adam, torch.optim.AdamW)


class StorageType:
    MEMORY = "memory"
    DISK = "disk"


def _extract_npz(blob: bytes) -> Dict[str, np.ndarray]:
    """Every member of an in-memory .npz, extracted over a thread pool
    for large archives (zip CRC and the member memcpy release the GIL;
    each worker opens its own view, zipfile handles are not
    thread-safe)."""
    with np.load(io.BytesIO(blob)) as npz:
        names = list(npz.files)
        n = min(RESTORE_THREADS, len(names))
        if n <= 1 or len(blob) < (32 << 20):
            return {k: npz[k] for k in names}
    from concurrent.futures import ThreadPoolExecutor

    def _group(keys):
        with np.load(io.BytesIO(blob)) as npz:
            return {k: npz[k] for k in keys}

    flat: Dict[str, np.ndarray] = {}
    with ThreadPoolExecutor(n) as pool:
        for part in pool.map(_group, [names[i::n] for i in range(n)]):
            flat.update(part)
    return flat


# ---------------------------------------------------------------------------
# the port's train state <-> {JAX flatten_state path: leaf}
# ---------------------------------------------------------------------------


def _param_paths(params) -> List[Tuple[str, torch.Tensor]]:
    leaves, _ = tree_flatten_with_path(params)
    return sorted(
        (path_str(p), t) for p, t in leaves if isinstance(t, torch.Tensor)
    )


def _opt_params(opt: torch.optim.Optimizer) -> List[torch.Tensor]:
    return [p for g in opt.param_groups for p in g["params"]]


def _opt_layout(opt: torch.optim.Optimizer) -> List[Tuple[str, str]]:
    """(state key in torch, optax field) of each per-param moment."""
    if isinstance(opt, _ADAM):
        if any(g.get("amsgrad") for g in opt.param_groups):
            raise NotImplementedError(
                "amsgrad has no optax adamw counterpart to checkpoint as"
            )
        return [("exp_avg", "mu"), ("exp_avg_sq", "nu")]
    if isinstance(opt, ChainOptimizer):
        first = opt.state[_opt_params(opt)[0]]
        return [(k, k) for k in first]
    raise NotImplementedError(
        f"no checkpoint layout for {type(opt).__name__}: torch Adam / "
        "AdamW and the port's optim/ optimizers have one"
    )


def _opt_count(opt: torch.optim.Optimizer) -> int:
    if isinstance(opt, ChainOptimizer):
        return int(opt.count)
    for p in _opt_params(opt):
        step = opt.state.get(p, {}).get("step")
        if step is not None:
            return int(step)
    return 0


def _opt_prefix(opt: torch.optim.Optimizer) -> str:
    """Where JAX's `flatten_state` files the optimizer's state: under
    `opt_state/0` for one optax chain over every param, under
    `opt_state/inner_states/<label>/inner_state/0` for the trained
    transform of a `multi_transform` (`models/lora.py`
    `lora_optimizer`: the frozen transform holds no state, so it has no
    key)."""
    label = getattr(opt, "multi_transform_label", None)
    if label is None:
        return "opt_state/0"
    return f"opt_state/inner_states/{label}/inner_state/0"


def _shard_key(path: str, rank: int) -> str:
    return f"{path}#shard{rank}_0"


def _leaves_and_shards(state: Dict[str, Any]) -> Tuple[
        Dict[str, torch.Tensor], Dict[str, Dict[str, Any]]]:
    """`state_leaves` and the shard table of the pieces among them
    ({path: {"shape", "dtype", "keys", "indices"}}, JAX's aux layout;
    empty for a state whole on its rank)."""
    if "opt_state" not in state:
        return {p: t.detach() for p, t in _param_paths(state)}, {}
    plan = state.get("layout")
    if plan is not None and not plan.sharded:
        plan = None
    table: Dict[str, Dict[str, Any]] = {}

    def key(path: str, param: str, t: torch.Tensor) -> str:
        if plan is None or plan.dim(param) is None:
            return path
        k = _shard_key(path, plan.mesh.rank)
        table[path] = {
            "shape": tuple(plan.shapes[param]),
            "dtype": _dtype_name(t.dtype),
            "keys": [k],
            "indices": [[[ix.start, ix.stop] for ix in
                         plan.index_of(param)]],
        }
        return k

    params = _param_paths(state["params"])
    by_id = {id(t): p for p, t in params}
    out: Dict[str, torch.Tensor] = {}
    ls = state.get("loss_scale")
    if ls is not None:
        out["loss_scale/scale"] = ls.scale
        out["loss_scale/good_steps"] = ls.good_steps
    opt = state["opt_state"]
    pre = _opt_prefix(opt)
    out[f"{pre}/count"] = torch.tensor(_opt_count(opt), dtype=torch.int32)
    opt_params = sorted(
        ((by_id[id(p)], p) for p in _opt_params(opt)), key=lambda x: x[0]
    )
    for k, field in _opt_layout(opt):
        for path, p in opt_params:
            t = opt.state.get(p, {}).get(k)
            t = torch.zeros_like(p) if t is None else t
            out[key(f"{pre}/{field}/{path}", path, t)] = t
    for path, t in params:
        out[key("params/" + path, path, t)] = t.detach()
    out["step"] = torch.tensor(int(state["step"]), dtype=torch.int32)
    return out, table


def state_leaves(state: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The train state as {JAX flatten_state path: tensor}: live tensors
    of the state where it has them, new ones (the optimizer's zero
    moments before its first step, the counts) where it does not. In
    JAX's flatten order. Any other tree of tensors (an adapter-only
    sub-tree, say) is its leaves by path, as JAX flattens any pytree.
    A leaf the state holds as an fsdp piece is this rank's piece, under
    `<path>#shard{rank}_0`."""
    return _leaves_and_shards(state)[0]


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).rsplit(".", 1)[-1]


def _staged_dtype(dtype: torch.dtype) -> str:
    """numpy dtype name of a leaf's staged bytes (bf16 as its bits)."""
    if dtype == torch.bfloat16:
        return "uint16"
    return str(torch.empty((), dtype=dtype).numpy().dtype)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """An owned host copy (a CPU leaf is a live tensor of the state)."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _aux(leaves: Dict[str, torch.Tensor],
         shards: Optional[Dict[str, Dict[str, Any]]] = None) -> bytes:
    meta = {
        "format": AUX_FORMAT,
        "paths": list(leaves),
        "shapes": {p: tuple(t.shape) for p, t in leaves.items()},
        "dtypes": {p: _dtype_name(t.dtype) for p, t in leaves.items()},
    }
    if shards:
        meta["shards"] = shards
    return pickle.dumps(meta)


class _PlainUnpickler(pickle.Unpickler):
    """Loads builtin values only: the port's aux holds nothing else,
    and an aux written by the JAX package (its treedef) is refused."""

    def find_class(self, module, name):
        raise pickle.UnpicklingError(f"{module}.{name} is not a plain value")


class _JaxAuxUnpickler(pickle.Unpickler):
    """Reads a JAX aux for its plain values (paths, the shard table with
    its slices): JAX's treedef, which needs jax to rebuild, loads as an
    opaque value that runs nothing."""

    def find_class(self, module, name):
        if (module, name) == ("builtins", "slice"):
            return slice
        return _Opaque


class _Opaque:
    """Whatever a JAX aux pickles beside its plain values: built from
    any arguments, holding nothing."""

    def __new__(cls, *args, **kwargs):
        return object.__new__(cls)

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass

    def __call__(self, *args, **kwargs):
        return _Opaque()


def _norm_index(ix) -> tuple:
    """A shard index as a tuple of slices: JAX's are slices already, the
    port's aux holds [start, stop] pairs."""
    return tuple(s if isinstance(s, slice) else slice(s[0], s[1])
                 for s in ix)


def _jax_shards(raw: Optional[bytes]) -> Dict[str, Dict[str, Any]]:
    """The shard table of an aux, JAX's or the port's ({path: {"shape",
    "dtype", "keys", "indices"}}, indices as tuples of slices), {} where
    it has none."""
    if not raw:
        return {}
    try:
        meta = _JaxAuxUnpickler(io.BytesIO(raw)).load()
    except (pickle.UnpicklingError, EOFError, ValueError, TypeError,
            AttributeError):
        return {}
    shards = meta.get("shards") if isinstance(meta, dict) else None
    if not isinstance(shards, dict):
        return {}
    return {p: dict(e, indices=[_norm_index(ix) for ix in e["indices"]])
            for p, e in shards.items()}


def _index_key(ix) -> tuple:
    return tuple(
        (s.start, s.stop, s.step) if isinstance(s, slice) else s
        for s in ix
    )


def _stitch_shards(flat: Dict[str, np.ndarray],
                   shards: Dict[str, Dict[str, Any]]) -> None:
    """Replace each sharded leaf's `#shard` keys in `flat` by the global
    array, in place (JAX `_reassemble_sharded`'s host stitch): only
    where the distinct shard indices cover the shape, since stitching
    some hosts' shards into zeros would make up a wrong array. Partial
    coverage raises JAX's KeyError (a restore of this rank's own pieces
    goes by their keys instead, `_restore`)."""
    for path, entry in shards.items():
        present = [(k, ix) for k, ix in zip(entry["keys"], entry["indices"])
                   if k in flat]
        shape = tuple(entry["shape"])
        total = int(np.prod(shape)) if shape else 1
        seen = {_index_key(ix): flat[k].size for k, ix in present}
        if not present or sum(seen.values()) < total:
            raise KeyError(
                f"cannot reassemble {path!r} on host: some shards were "
                "staged on other hosts, and the port restores whole "
                "arrays only"
            )
        out = np.zeros(shape, dtype=flat[present[0][0]].dtype)
        for k, ix in present:
            out[ix] = flat.pop(k)
        flat[path] = out


def _read_aux(raw: Optional[bytes]) -> Dict[str, Any]:
    if not raw:
        return {}
    try:
        meta = _PlainUnpickler(io.BytesIO(raw)).load()
    except (pickle.UnpicklingError, EOFError, ValueError):
        return {}  # not the port's (a JAX aux): the keys speak alone
    if isinstance(meta, dict) and meta.get("format") == AUX_FORMAT:
        return meta
    return {}


def flatten_state(state: Dict[str, Any]) -> Tuple[Dict[str, np.ndarray],
                                                   bytes]:
    """Train state -> ({JAX flatten_state path: host ndarray}, aux)."""
    leaves, shards = _leaves_and_shards(state)
    return {p: _to_numpy(t) for p, t in leaves.items()}, _aux(leaves,
                                                             shards)


def _from_numpy(arr: np.ndarray, dtype_name: Optional[str]) -> torch.Tensor:
    """A host leaf as a CPU tensor, bf16 from its bit pattern: the
    port's uint16 (named by aux) or a JAX bf16 array (ml_dtypes
    `bfloat16`, or a 2-byte void where numpy does not know it)."""
    if not (arr.flags.c_contiguous and arr.flags.writeable):
        arr = arr.copy()
    if (dtype_name == "bfloat16" or arr.dtype.name == "bfloat16"
            or (arr.dtype.kind == "V" and arr.dtype.itemsize == 2)):
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _check(src, like: torch.Tensor, path: str):
    """`src` (a tensor or a `_Leaves.spec`) matches `like` in shape and
    dtype."""
    if tuple(src.shape) != tuple(like.shape) or src.dtype != like.dtype:
        raise ValueError(
            f"{path}: staged {tuple(src.shape)} {src.dtype}, the target "
            f"holds {tuple(like.shape)} {like.dtype}"
        )


_BOUNCE_BYTES = 64 << 20


def _to_card(items) -> None:
    """Fill card tensors through two page-locked bounce buffers: for each
    (dst, fill), `fill(buf, off)` writes the source's bytes [off, off +
    len(buf)) into `buf`, a uint8 CPU tensor, and the DMA out of one
    buffer overlaps the filling of the other (a copy from pageable
    memory would stage through the driver's buffers at a fraction of
    the link's rate)."""
    stream = torch.cuda.current_stream(items[0][0].device)
    bufs = [torch.empty(_BOUNCE_BYTES, dtype=torch.uint8, pin_memory=True)
            for _ in range(2)]
    free = [None, None]   # event: the DMA out of that buffer is done
    k = 0
    with torch.no_grad():
        for dst, fill in items:
            d = dst.view(-1).view(torch.uint8)
            for off in range(0, d.numel(), _BOUNCE_BYTES):
                n = min(_BOUNCE_BYTES, d.numel() - off)
                if free[k] is not None:
                    free[k].synchronize()
                fill(bufs[k][:n], off)
                d[off:off + n].copy_(bufs[k][:n], non_blocking=True)
                free[k] = torch.cuda.Event()
                free[k].record(stream)
                k ^= 1
    stream.synchronize()


def _streams_to_card(dst: torch.Tensor) -> bool:
    return dst.is_cuda and dst.is_contiguous()


def _piece_indices(aux: Optional[bytes]) -> Dict[str, tuple]:
    """{shard key: the slices of the global leaf it holds} of an aux's
    shard table."""
    return {k: ix for e in _jax_shards(aux).values()
            for k, ix in zip(e["keys"], e["indices"])}


class _Spec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


class _Leaves:
    """A restore's source: {path: ndarray} (a checkpoint file's, or a
    JAX state's `flatten_state`), bf16 leaves as named by the port's
    aux or by their own dtype."""

    def __init__(self, flat: Dict[str, np.ndarray], aux: Optional[bytes]):
        self.flat = flat
        self.dtypes = _read_aux(aux).get("dtypes", {})
        self.index = _piece_indices(aux)

    def has(self, path: str) -> bool:
        return path in self.flat

    def tensor(self, path: str) -> torch.Tensor:
        if path not in self.flat:
            raise KeyError(f"state leaf {path!r} missing from staged data")
        return _from_numpy(np.asarray(self.flat[path]),
                           self.dtypes.get(path))

    spec = tensor   # shape and dtype: a view of the array costs nothing

    def copy_into(self, pairs: List[Tuple[torch.Tensor, str]]) -> None:
        staged = []
        with torch.no_grad():
            for dst, path in pairs:
                src = self.tensor(path)
                if _streams_to_card(dst):
                    sb = src.contiguous().view(-1).view(torch.uint8)
                    staged.append((dst, lambda buf, off, sb=sb: buf.copy_(
                        sb[off:off + buf.numel()])))
                else:
                    dst.copy_(src)
        if staged:
            _to_card(staged)


class _ShmLeaves(_Leaves):
    """A restore's source read from the shm segment's file (`fd`, at the
    offsets of `meta`) straight into the bounce buffers, with no host
    copy of the whole state."""

    def __init__(self, fd: int, meta):
        self.fd = fd
        self.meta = {tm.path: tm for tm in meta.tensors}
        self.dtypes = _read_aux(meta.aux).get("dtypes", {})
        self.index = _piece_indices(meta.aux)

    def has(self, path: str) -> bool:
        return path in self.meta

    def _tm(self, path):
        if path not in self.meta:
            raise KeyError(f"state leaf {path!r} missing from staged data")
        return self.meta[path]

    def spec(self, path: str) -> "_Spec":
        tm = self._tm(path)
        return _Spec(tuple(tm.shape), _from_numpy(
            np.empty((0,), np.dtype(tm.dtype)), self.dtypes.get(path)).dtype)

    def tensor(self, path: str) -> torch.Tensor:
        tm = self._tm(path)
        arr = np.empty(tm.shape, np.dtype(tm.dtype))
        pread_full(self.fd, memoryview(arr).cast("B"), tm.offset, path)
        return _from_numpy(arr, self.dtypes.get(path))

    def copy_into(self, pairs: List[Tuple[torch.Tensor, str]]) -> None:
        staged = []
        with torch.no_grad():
            for dst, path in pairs:
                if not _streams_to_card(dst):
                    dst.copy_(self.tensor(path))
                    continue
                base = self._tm(path).offset
                staged.append((dst, lambda buf, off, base=base, path=path:
                               pread_full(self.fd, memoryview(buf.numpy()),
                                          base + off, path)))
        if staged:
            _to_card(staged)


def _owned(src: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A copy of `src` on `like`'s device (src may view a buffer that is
    reused once the restore returns)."""
    return torch.empty_like(like, memory_format=torch.contiguous_format
                            ).copy_(src)


def train_state_from_numpy(state: Dict[str, Any],
                           flat: Dict[str, np.ndarray],
                           aux: Optional[bytes] = None) -> Dict[str, Any]:
    """Load {JAX flatten_state path: ndarray} into the port's train
    state `state`, in place: params by `copy_`, the optimizer state
    keyed by `state`'s own param objects (created where torch has none
    yet), the counts, `step` and the loss scale. `flat` is a checkpoint
    of either package (the JAX package's `flatten_state(state)[0]`
    carries a whole JAX train state across), `aux` the port's
    description of its dtypes where it wrote it. Every key, shape and
    dtype is checked before anything is written, so a checkpoint that
    does not fit the state leaves it as it was. Returns `state`."""
    return _restore(state, _Leaves(flat, aux))


def _restore(state: Dict[str, Any], leaves: _Leaves) -> Dict[str, Any]:
    """`train_state_from_numpy` from any source of leaves. Where the
    target holds fsdp pieces (its "layout"), each piece comes from this
    rank's staged piece where that holds the same slice, else is cut
    from the whole leaf; KeyError where the source has neither."""
    plan = state.get("layout")
    if plan is not None and not plan.sharded:
        plan = None
    direct = []   # (destination tensor, key)
    cuts = []     # (destination tensor, key of the whole leaf, slices)

    def resolve(like: torch.Tensor, path: str, param: str):
        """Where `path`'s bytes for `like` (a live tensor, or the param
        a moment is made like) are: ("direct", key) or ("cut", key,
        slices); shape and dtype checked."""
        if plan is None or plan.dim(param) is None:
            _check(leaves.spec(path), like, path)
            return ("direct", path)
        want = plan.index_of(param)
        mine = _shard_key(path, plan.mesh.rank)
        if leaves.has(mine) and _index_key(
                leaves.index.get(mine, ())) == _index_key(want):
            _check(leaves.spec(mine), like, mine)
            return ("direct", mine)
        if leaves.has(path):
            src = leaves.spec(path)
            if (tuple(src.shape) != tuple(plan.shapes[param])
                    or src.dtype != like.dtype):
                raise ValueError(
                    f"{path}: staged {tuple(src.shape)} {src.dtype}, the "
                    f"target's whole leaf is {tuple(plan.shapes[param])} "
                    f"{like.dtype}")
            return ("cut", path, want)
        raise KeyError(
            f"state leaf {path!r}: the staged data holds neither this "
            f"rank's piece {[(i.start, i.stop) for i in want]} nor the "
            "whole leaf (a memory segment of another layout: restore "
            "from storage)")

    def queue(dst: torch.Tensor, how) -> None:
        if how[0] == "direct":
            direct.append((dst, how[1]))
        else:
            cuts.append((dst, how[1], how[2]))

    params = _param_paths(state["params"])
    by_id = {id(t): p for p, t in params}
    for path, t in params:
        queue(t.detach(), resolve(t, "params/" + path, path))
    opt = state["opt_state"]
    pre = _opt_prefix(opt)
    count = int(leaves.tensor(f"{pre}/count"))
    created = []  # (param, key, how): moments torch has not made yet
    for key, field in _opt_layout(opt):
        for p in _opt_params(opt):
            param = by_id[id(p)]
            path = f"{pre}/{field}/{param}"
            cur = opt.state.get(p, {}).get(key)
            how = resolve(p if cur is None else cur, path, param)
            if cur is None:   # torch's Adam before its first step
                created.append((p, key, how))
            else:
                queue(cur, how)
    step = int(leaves.tensor("step"))
    ls = state.get("loss_scale")
    if ls is not None:
        scale = leaves.tensor("loss_scale/scale")
        good = leaves.tensor("loss_scale/good_steps")
        _check(scale, ls.scale, "loss_scale/scale")
        _check(good, ls.good_steps, "loss_scale/good_steps")
    for p, key, how in created:
        opt.state[p][key] = torch.empty_like(
            p, memory_format=torch.contiguous_format)
        queue(opt.state[p][key], how)
    leaves.copy_into(direct)
    with torch.no_grad():
        for dst, key, ix in cuts:
            dst.copy_(leaves.tensor(key)[ix])
    if isinstance(opt, _ADAM):
        for g in opt.param_groups:
            on_device = g.get("capturable") or g.get("fused")
            for p in g["params"]:
                opt.state[p]["step"] = torch.tensor(
                    float(count), dtype=torch.float32,
                    device=p.device if on_device else "cpu")
    else:
        opt.count = count
    state["step"] = step
    if ls is not None:
        state["loss_scale"] = LossScaleState(
            scale=_owned(scale, ls.scale),
            good_steps=_owned(good, ls.good_steps))
    return state


def unflatten_state(flat: Dict[str, np.ndarray], aux: Optional[bytes] = None,
                    target: Optional[Dict[str, Any]] = None,
                    device: DeviceLike = None) -> Any:
    """Inverse of flatten_state. With `target` (a train state), restore
    into it in place (`train_state_from_numpy`) and return it; without,
    a nested dict of tensors on `device` (default: the card), one level
    per path component."""
    if target is not None:
        return train_state_from_numpy(target, flat, aux)
    dev = resolve_device(device)
    meta = _read_aux(aux)
    for path in meta.get("paths", ()):
        if path not in flat:
            raise KeyError(f"state leaf {path!r} missing from staged data")
    dtypes = meta.get("dtypes", {})
    tree: Dict[str, Any] = {}
    for path, arr in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = _from_numpy(np.asarray(arr), dtypes.get(path)).to(dev)
    return tree


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


class CheckpointEngine:
    """Save/load a train state with memory staging + async persistence."""

    def __init__(
        self,
        checkpoint_dir: str,
        storage: Optional[CheckpointStorage] = None,
        job_name: Optional[str] = None,
        node_rank: Optional[int] = None,
        local_saver: bool = True,
        replica_manager=None,
        max_to_keep: int = 0,
        num_nodes: int = 1,
    ):
        self.checkpoint_dir = checkpoint_dir
        # > 0: keep only the newest N committed step dirs
        self.max_to_keep = max_to_keep
        self.replica_manager = replica_manager
        self._replica_thread: Optional[threading.Thread] = None
        self._backup_lock = threading.Lock()
        self._pending_backup = None  # latest-wins parked backup
        self._staging_thread: Optional[threading.Thread] = None
        self._staging_error: Optional[BaseException] = None
        # what the last staging did (seconds in the staging thread from
        # start to publish, bytes, whether the segment was page-locked)
        self.last_staging_s = 0.0
        self.last_staged_bytes = 0
        self.pinned = False
        # where the last `load` found its state: "memory", "replica",
        # "storage" or None (nothing saved)
        self.last_load_source: Optional[str] = None
        # on-device snapshot buffers, by path, reused by every async save
        self._snapshot: Dict[str, torch.Tensor] = {}
        self.storage = storage or get_checkpoint_storage()
        self.job_name = job_name or os.environ.get(NodeEnv.JOB_NAME,
                                                   "default")
        self.node_rank = (
            node_rank
            if node_rank is not None
            else int(os.environ.get(NodeEnv.NODE_RANK, 0))
        )
        self._ipc: Optional[LocalSocketServer] = None
        self._local_saver: Optional[AsyncCheckpointSaver] = None
        if not server_alive(self.job_name):
            if not local_saver:
                raise RuntimeError(
                    f"no agent IPC server for job {self.job_name!r}"
                )
            # no agent on this host: run the IPC server and the saver
            # in-process so the API still works
            self._ipc = LocalSocketServer(self.job_name)
            self._ipc.start()
            # num_nodes: the hosts whose files make a step whole (the
            # saver of node 0 commits the step when all have persisted)
            self._local_saver = AsyncCheckpointSaver(
                job_name=self.job_name,
                node_rank=self.node_rank,
                num_nodes=num_nodes,
                storage=self.storage,
            )
            self._local_saver.start()
        self.shm_handler = SharedMemoryHandler(self.job_name, self.node_rank)
        self.event_queue = SharedQueue(CKPT_QUEUE_NAME, self.job_name)

    # ---- save ------------------------------------------------------------

    def _event(self, step: int) -> dict:
        event = {"step": step, "path": self.checkpoint_dir}
        if self.max_to_keep:
            # the saver owns the storage that commits: the retention
            # policy rides the event to it
            event["max_to_keep"] = self.max_to_keep
        return event

    def prepare(self, state: Any) -> float:
        """Allocate what saving `state` asynchronously needs, ahead of
        the first save: the snapshot buffers and, for a state on the
        card, the shm slot the first save writes, page-locked (the other
        slot is made at the first save that needs it, so a host holds
        one slot until then). Returns the seconds it took; later saves
        of a state of the same layout allocate only that other slot,
        once."""
        t0 = time.monotonic()
        self.wait_for_staging()
        leaves = state_leaves(state)
        self._snapshot_buffers(leaves)
        if any(t.is_cuda for t in leaves.values()):
            _, total = _layout_of(leaves)
            with self.shm_handler.lock:
                self.shm_handler.reserve(total)
                self.pinned = self.shm_handler.pin_for_cuda()
        return time.monotonic() - t0

    def _snapshot_buffers(self, leaves: Dict[str, torch.Tensor]):
        snap = self._snapshot
        if list(snap) != list(leaves) or any(
            snap[p].shape != t.shape or snap[p].dtype != t.dtype
            or snap[p].device != t.device for p, t in leaves.items()
        ):
            snap.clear()
            snap.update({p: torch.empty(t.shape, dtype=t.dtype,
                                        device=t.device)
                         for p, t in leaves.items()})
        return snap

    def save_to_memory_async(self, step: int, state: Any,
                             persist: bool = False) -> float:
        """Copy the state into the snapshot on its device, then stage the
        snapshot into shm in a background thread (and queue its persist
        if `persist`). Returns the seconds the caller blocked: waiting
        for the previous staging, then dispatching the copies."""
        t0 = time.monotonic()
        # one staging in flight: it reads the snapshot this save is
        # about to overwrite; raises if it failed rather than dropping it
        self.wait_for_staging()
        leaves, shards = _leaves_and_shards(state)
        aux = _aux(leaves, shards)
        snap = self._snapshot_buffers(leaves)
        with torch.no_grad():
            for p, t in leaves.items():
                snap[p].copy_(t)
        del leaves
        ready = _record_ready(snap)

        def _stage():
            try:
                self._stage_to_shm(step, snap, aux, ready)
                if persist:
                    self.event_queue.put(self._event(step))
            except Exception as e:  # noqa: BLE001
                logger.exception("async checkpoint staging failed")
                self._staging_error = e
            finally:
                self.shm_handler.close_thread_conns()
                self.event_queue.close_thread()

        self._staging_thread = threading.Thread(
            target=_stage, name="ckpt-staging", daemon=True
        )
        self._staging_thread.start()
        return time.monotonic() - t0

    def wait_for_staging(self):
        """Block until the last async staging has reached shm. Raises
        if it failed (that checkpoint never landed)."""
        t = self._staging_thread
        if t is not None:
            t.join()
        err = self._staging_error
        if err is not None:
            self._staging_error = None
            raise RuntimeError(
                "async checkpoint staging failed; the last "
                "save_to_memory_async never reached shm"
            ) from err

    def save_to_memory(self, step: int, state: Any) -> float:
        """Stage the state into shm in the caller's thread; returns the
        seconds it blocked."""
        t0 = time.monotonic()
        # an in-flight async staging lands first, or its older snapshot
        # could overwrite this newer state
        self.wait_for_staging()
        leaves, shards = _leaves_and_shards(state)
        self._stage_to_shm(step, leaves, _aux(leaves, shards),
                           _record_ready(leaves))
        return time.monotonic() - t0

    def _stage_to_shm(self, step: int, leaves: Dict[str, torch.Tensor],
                      aux: bytes, ready) -> None:
        """Copy `leaves` into the segment and publish them as `step`.
        Device leaves go on a side CUDA stream that first waits for
        `ready` (recorded after the work that produced them), so the
        copies do not queue behind, or hold up, the training stream."""
        t0 = time.monotonic()
        tensors, total = _layout_of(leaves)
        stream = None
        if ready is not None:
            stream = torch.cuda.Stream(device=ready[0])
            stream.wait_event(ready[1])
        with self.shm_handler.lock:
            buf = self.shm_handler.reserve(total)
            if stream is not None:
                self.pinned = self.shm_handler.pin_for_cuda()
            ctx = (torch.cuda.stream(stream) if stream is not None
                   else contextlib.nullcontext())
            dst = None
            with ctx:
                for tm, t in zip(tensors, leaves.values()):
                    if tm.nbytes == 0:
                        continue
                    dst = torch.from_numpy(np.frombuffer(
                        buf, dtype=np.uint8, count=tm.nbytes,
                        offset=tm.offset))
                    dst.copy_(t.reshape(-1).view(torch.uint8),
                              non_blocking=True)
            del dst
            if stream is not None:
                stream.synchronize()
            self.shm_handler.publish(step, tensors, total,
                                     self.checkpoint_dir, aux)
            flat = (self.shm_handler.load_flat_state()[1]
                    if self.replica_manager is not None else None)
        self.last_staging_s = time.monotonic() - t0
        self.last_staged_bytes = total
        if flat is not None:
            self._queue_backup(step, flat, aux)

    def _queue_backup(self, step: int, flat, aux: bytes) -> None:
        """Ship the staged state to the replica in the background (the
        reference backs up to a peer's shm asynchronously too). If the
        previous backup is still in flight (a partition stalling its
        RPCs, say), park this one in a latest-wins slot the backup
        thread drains: never block the staging, never leave the replica
        stale once the partition heals."""
        with self._backup_lock:
            if (self._replica_thread is None
                    or not self._replica_thread.is_alive()):
                self._pending_backup = None
                self._replica_thread = threading.Thread(
                    target=self._backup_drain, args=(step, flat, aux),
                    name="ckpt-replica", daemon=True,
                )
                self._replica_thread.start()
            else:
                logger.info(
                    "replica backup for step %d parked (previous still in "
                    "flight; latest wins)", step,
                )
                self._pending_backup = (step, flat, aux)

    def _backup_drain(self, step: int, flat, aux: bytes) -> None:
        """Backup-thread body: ship the given state, then whatever newer
        state was parked while shipping."""
        while True:
            try:
                self.replica_manager.backup(step, flat, aux)
            except Exception:  # noqa: BLE001 — replica is best-effort
                logger.warning("replica backup for step %d failed", step,
                               exc_info=True)
            with self._backup_lock:
                if self._pending_backup is None:
                    # the exit decision and the saver's liveness check
                    # share this lock: clear the slot here, so a save
                    # racing this exit starts a fresh thread instead of
                    # parking a backup nobody drains
                    if self._replica_thread is threading.current_thread():
                        self._replica_thread = None
                    return
                step, flat, aux = self._pending_backup
                self._pending_backup = None

    def save_to_storage(self, step: int, state: Any) -> float:
        """Stage asynchronously and queue the persist once staged
        (reference save_to_storage); returns the blocking seconds."""
        return self.save_to_memory_async(step, state, persist=True)

    # ---- load ------------------------------------------------------------

    def load_from_memory(
        self, target: Any = None, device: DeviceLike = None
    ) -> Tuple[int, Optional[Any]]:
        # the shared lock keeps a concurrent writer resize from tearing
        # this read; into a target the leaves go straight from the
        # segment's file to their tensors, with no host copy of the state
        with self.shm_handler.lock:
            if target is None:
                meta, flat = self.shm_handler.load_flat_state()
                if meta is None:
                    return -1, None
                return meta.step, unflatten_state(flat, meta.aux,
                                                  device=device)
            meta, fd = self.shm_handler.open_staged()
            if meta is None:
                return -1, None
            try:
                return meta.step, _restore(target, _ShmLeaves(fd, meta))
            finally:
                os.close(fd)

    def load_from_storage(
        self, step: Optional[int] = None, target: Any = None,
        device: DeviceLike = None,
    ) -> Tuple[int, Optional[Any]]:
        """This host's files of `step` (default: the tracker's): a state
        whole on each rank is all in its own file. A checkpoint of
        pieces (the port's fsdp state, or a JAX checkpoint written by
        several processes: `#shard{proc}_{i}` keys and a shard table)
        has every host's files and shard tables read and each split
        leaf stitched whole (a KeyError where the pieces do not cover
        it); the restore cuts the target's pieces from it."""
        if step is None:
            step = read_tracker_step(self.storage, self.checkpoint_dir)
        if step < 0:
            return -1, None
        step_dir = os.path.join(self.checkpoint_dir, str(step))
        own = f"host_{self.node_rank}.npz"
        blob = self.storage.read(os.path.join(step_dir, own))
        if blob is None:
            return -1, None
        aux = self.storage.read(
            os.path.join(step_dir, f"aux_{self.node_rank}.pkl"))
        flat = _extract_npz(blob)
        del blob
        shards = _jax_shards(aux)
        if shards:
            listing = self.storage.listdir(step_dir) or []
            for name in sorted(listing):
                if name.startswith("host_") and name.endswith(".npz") \
                        and name != own:
                    other = self.storage.read(os.path.join(step_dir, name))
                    if other is not None:
                        flat.update(_extract_npz(other))
                elif name.startswith("aux_"):
                    for path, entry in _jax_shards(self.storage.read(
                            os.path.join(step_dir, name))).items():
                        mine = shards.setdefault(path, dict(
                            entry, keys=[], indices=[]))
                        for k, ix in zip(entry["keys"], entry["indices"]):
                            if k not in mine["keys"]:
                                mine["keys"].append(k)
                                mine["indices"].append(ix)
            _stitch_shards(flat, shards)
        return step, unflatten_state(flat, aux, target, device)

    def load(
        self, target: Any = None, device: DeviceLike = None
    ) -> Tuple[int, Optional[Any]]:
        """Memory-first restore: shm wins if its step >= the tracker's;
        else the replica where it is at least as fresh as the tracker,
        else storage, else an older replica (JAX's order). A torn or
        unreadable shm, and a replica that fails or does not fit,
        fall back to storage."""
        # this engine's own staging in flight would leave shm older
        self.wait_for_staging()
        shm_meta = self.shm_handler.get_meta()
        mem_step = shm_meta.step if shm_meta is not None else -1
        disk_step = read_tracker_step(self.storage, self.checkpoint_dir)
        step, state = -1, None
        if mem_step >= 0 and mem_step >= disk_step:
            try:
                step, state = self.load_from_memory(target, device)
            except (KeyError, ValueError, ShmIntegrityError) as e:
                logger.warning(
                    "shm restore failed (%s); falling back to storage", e
                )
                step, state = -1, None
        source = "memory" if state is not None else None
        tried_replica = False
        if state is None and self.replica_manager is not None:
            # a respawned node: the replica is DRAM on the master; when it
            # is at least as fresh as the tracker, take it before paying
            # the storage round trip
            rstep = self._peek_replica()
            if rstep >= 0 and rstep >= disk_step:
                tried_replica = True
                step, state = self._load_replica(target, device)
                if state is not None:
                    source = "replica"
                    logger.info("restored step %d from replica (fresher "
                                "than storage step %d)", step, disk_step)
        if state is None:
            step, state = self.load_from_storage(
                disk_step if disk_step >= 0 else None, target, device
            )
            source = "storage" if state is not None else None
        if (state is None and self.replica_manager is not None
                and not tried_replica):
            # storage had nothing readable: an older replica is still
            # better than no state
            step, state = self._load_replica(target, device)
            if state is not None:
                source = "replica"
                logger.info("restored step %d from replica", step)
        self.last_load_source = source
        return step, state

    def _peek_replica(self) -> int:
        """The replica's step, -1 where the master is out of reach: the
        restore then falls through to storage. Unlike the JAX engine,
        whose `peek_step` call outside its try fails the restore."""
        try:
            return self.replica_manager.peek_step()
        except (ConnectionError, OSError) as e:
            logger.warning("replica step unreadable (%s); falling back to "
                           "storage", e)
            return -1

    def _load_replica(self, target, device) -> Tuple[int, Optional[Any]]:
        """The replica's (step, state); (-1, None) where it does not fit
        the target (KeyError / ValueError) or the master is out of reach
        (ConnectionError / OSError): the caller falls through to storage
        instead of failing the restore."""
        try:
            return self.replica_manager.restore_state(target=target,
                                                      device=device)
        except (KeyError, ValueError, ConnectionError, OSError) as e:
            logger.warning("replica restore failed (%s); falling back to "
                           "storage", e)
            return -1, None

    def wait_for_persist(self, step: int, timeout: float = 60.0) -> bool:
        """Block until `step` is committed to storage (tests/shutdown)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if read_tracker_step(self.storage, self.checkpoint_dir) >= step:
                return True
            time.sleep(0.05)
        return False

    def close(self):
        """Let an in-flight staging and replica backup land; with an
        in-process saver, let it persist what was queued before stopping
        it and the IPC server. The segment stays (it is the memory
        checkpoint)."""
        t = self._staging_thread
        if t is not None and t.is_alive():
            t.join(timeout=CheckpointConstant.SAVE_TIMEOUT_SECS)
        # the drain clears its own slot under the lock as it exits
        with self._backup_lock:
            rt = self._replica_thread
        if rt is not None and rt.is_alive():
            # let an in-flight backup commit rather than die mid-write
            rt.join(timeout=CheckpointConstant.SAVE_TIMEOUT_SECS)
        self._snapshot.clear()
        if self._local_saver is not None:
            self.event_queue.put(STOP_EVENT)
            if not self._local_saver.join(
                    CheckpointConstant.SAVE_TIMEOUT_SECS):
                logger.warning("checkpoint saver still persisting at close")
            self._local_saver.stop()
            self._local_saver.shm_handler.close()
        self.shm_handler.close()
        self.shm_handler.close_thread_conns()
        self.event_queue.close_thread()
        if self._ipc is not None:
            self._ipc.stop()


def _layout_of(leaves: Dict[str, torch.Tensor]):
    return layout(
        (p, tuple(t.shape), _staged_dtype(t.dtype),
         t.numel() * t.element_size())
        for p, t in leaves.items()
    )


def _record_ready(leaves: Dict[str, torch.Tensor]):
    """(device, event recorded on its current stream) where a leaf lies
    on the card, else None."""
    dev = next((t.device for t in leaves.values() if t.is_cuda), None)
    if dev is None:
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(dev))
    return dev, ev


class Checkpointer:
    """User-facing API (reference checkpointer.py:23).

    save_checkpoint(step, state, MEMORY) stages to host shm in the
    background, blocking only for the on-device snapshot; DISK also
    persists it asynchronously. The last staged state survives a
    training-process crash where the segment and the saver live with
    the agent.
    """

    def __init__(self, checkpoint_dir: str, **kw):
        self.engine = CheckpointEngine(checkpoint_dir, **kw)

    def save_checkpoint(
        self,
        step: int,
        state: Any,
        storage_type: str = StorageType.DISK,
    ) -> float:
        if storage_type == StorageType.MEMORY:
            return self.engine.save_to_memory_async(step, state)
        return self.engine.save_to_storage(step, state)

    def prepare(self, state: Any) -> float:
        return self.engine.prepare(state)

    def load_checkpoint(
        self, target: Any = None, device: DeviceLike = None
    ) -> Tuple[int, Optional[Any]]:
        return self.engine.load(target, device)

    def wait_latest_checkpoint(self, step: int, timeout: float = 60.0):
        return self.engine.wait_for_persist(step, timeout)

    def close(self):
        self.engine.close()
