"""``torch.distributed.checkpoint`` (DCP) backend: ``--ckpt_backend orbax``.

Port of ``stochastic_gradient_push_tpu/utils/orbax_ckpt.py::
OrbaxCheckpointManager`` with the reference's surface (``save``,
``exists``, ``restore``, ``restore_best``, ``wait``, ``close``,
``path_for_epoch``, ``checkpoint_path``, ``saves_global_state``), so
``utils/checkpoint.py::ClusterManager`` composes with either backend:

* **One process**: one root for the whole rank-stacked state,
  ``{tag}dcp_r{rank}_n{world}``.  A save copies the state's tensors to
  the host (the staging, so the run may go on changing the state) and
  returns; a worker thread writes the copy with ``dcp.save``.  A new
  save, :meth:`wait`, :meth:`restore` and a preemption exit wait for
  the one in flight.  (``dcp.async_save`` would stage its own second
  copy of the host tensors.)
* **Several processes** (``torch.distributed`` initialized, world > 1):
  one shared root, ``{tag}dcp_global_n{world}``, saved synchronously (as
  the reference, ``orbax_ckpt.py:62-65``): every process writes its own
  rank rows.  DCP's planner takes a plain tensor for replicated and
  writes one process's copy only, so each rank-row tensor goes in as a
  ``DTensor`` sharded on dim 0 (``Shard(0)``) over a CPU mesh of the
  processes, on a gloo group (the default group when it is gloo, as
  where the processes share one card, else one of its own).
  ``saves_global_state`` is then True.  With ``layout`` (the LM's
  ``(gossip, pipe, ep, seq, tp)`` processes, ``parallel/mesh.py::
  DpSpLayout``) the CPU mesh is ``(dp, pp, ep, sp, tp)`` and a leaf is
  placed ``[Shard(0), Replicate(), Replicate(), Replicate(), Shard(k)]``
  when tp splits its dim ``k`` (the ``[out, in]`` layout after the rank
  dim; the held-shard dim is dropped), with ``Shard(1)`` on ep for an
  expert stack (its expert dim, ``parallel/ep.py``; at tp > 1 tp on its
  F dim), with ``Shard(1)`` on pp for a pipeline stage leaf (the
  held-stage dim dropped, its ``L/pp`` layers on the layer dim: the
  logical ``[dp, L, ...]``; an expert stack's expert dim is then dim 2),
  else ``Replicate()`` on every dim but dp: the identical copies of a
  replica's leaf are written once (a replicated leaf once for all the
  stages), and a split leaf as its logical rows.  A process that
  destroys its default group after such a save and makes a new one on
  the same port may reach the old group's store (seen with torch 2.13
  on gloo): run one job a process, or keep one group across jobs.

DCP has no manager, so this module keeps one: a step is the directory
``{root}/{step}`` (the epoch, or ``epoch_id``: the LM CLI's step); a save
writes ``{root}/.tmp.{step}`` and renames it into place once DCP has
written its ``.metadata`` (last), so a step directory without
``.metadata`` is an unfinished save that neither "latest" nor retention
counts.  Retention keeps the newest ``max_to_keep`` steps; the best
model lives under ``{root}/best`` with a retention of its own (one), so
pruning the recent steps never deletes it.  The meta rides inside the
checkpoint as JSON text (one process's copy under several).

A checkpoint of another world size is not resharded
(:meth:`refuse_other_worlds`): the reference's cross-world resume reads
the per-rank files, not this backend.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import re
import shutil
import time
import warnings

import torch

__all__ = ["DcpCheckpointManager"]

_ROOT_RE = r"dcp_(?:r\d+|global)_n(\d+)$"


def _map(tree, fn):
    """Leaf map over nested dicts: tensors through ``fn``, other values
    as they are."""
    return _map_named(tree, lambda _, t: fn(t))


def _map_named(tree, fn, key: str = ""):
    """:func:`_map` with each tensor's dict key: ``fn(key, tensor)``."""
    if isinstance(tree, dict):
        return {k: _map_named(v, fn, k) for k, v in tree.items()}
    return fn(key, tree) if isinstance(tree, torch.Tensor) else tree


def _to_tree(state) -> dict:
    """A train state as the nested dict DCP saves (dict keys, the FIFO
    by slot index); any other nested dict as it is."""
    if not hasattr(state, "gossip"):
        return state
    g = state.gossip
    tree = {"step": int(state.step), "phase": int(g.phase),
            "params": state.params, "opt_state": state.opt_state,
            "batch_stats": state.batch_stats, "ps_weight": g.ps_weight,
            "in_flight": {str(k): {"params": p, "ps_weight": w}
                          for k, (p, w) in enumerate(g.in_flight)}}
    if g.ef_residual is not None:
        tree["ef_residual"] = g.ef_residual
    return tree


def _from_tree(template, tree):
    """``tree`` (host tensors) in ``template``'s structure, each tensor
    on its template's device and dtype."""
    def like(tmpl, got):
        if isinstance(tmpl, dict):
            return {k: like(v, got[k]) for k, v in tmpl.items()}
        if isinstance(tmpl, torch.Tensor):
            return got.to(device=tmpl.device, dtype=tmpl.dtype)
        return got

    if not hasattr(template, "gossip"):
        return like(template, tree)
    from ..algorithms.api import GossipState

    flat = like(_to_tree(template), tree)
    return dataclasses.replace(
        template, step=flat["step"], params=flat["params"],
        opt_state=flat["opt_state"], batch_stats=flat["batch_stats"],
        gossip=GossipState(
            phase=flat["phase"], ps_weight=flat["ps_weight"],
            in_flight=tuple((s["params"], s["ps_weight"]) for _, s in
                            sorted(flat["in_flight"].items(),
                                   key=lambda kv: int(kv[0]))),
            ef_residual=flat.get("ef_residual")))


class DcpCheckpointManager:
    """DCP checkpoints of a rank-stacked train state (or any nested dict
    of tensors whose dim 0 is the rank rows this process holds), the
    counterpart of the reference's ``OrbaxCheckpointManager``.
    ``all_workers=False`` names the root after rank 0 (one process holds
    every rank, so the whole state is saved either way)."""

    def __init__(self, directory: str, tag: str = "", rank: int = 0,
                 world_size: int = 1, all_workers: bool = True,
                 max_to_keep: int = 3, async_save: bool = True,
                 layout=None):
        import torch.distributed as dist

        self.directory = os.path.abspath(directory)
        self.tag = tag
        self.rank = rank if all_workers else 0
        self.world_size = int(world_size)
        self.max_to_keep = int(max_to_keep)
        self.layout = layout
        self._multi = dist.is_initialized() and dist.get_world_size() > 1
        self._group = self._mesh = None
        if self._multi:
            from torch.distributed.device_mesh import DeviceMesh

            # the rows travel as host tensors: a gloo group (the default
            # one when it is gloo; every process builds the manager at the
            # same point, so creating another is collective)
            gloo = dist.get_backend() == "gloo"
            self._group = (dist.group.WORLD if gloo
                           else dist.new_group(backend="gloo"))
            if layout is None:
                self._mesh = DeviceMesh.from_group(self._group, "cpu")
            else:
                self._mesh = DeviceMesh(
                    "cpu", torch.arange(layout.world).reshape(
                        layout.dp, layout.pp, layout.ep, layout.sp,
                        layout.tp),
                    mesh_dim_names=("dp", "pp", "ep", "sp", "tp"),
                    **({} if gloo else
                       {"backend_override": (("gloo", None),) * 5}))
            self._proc = dist.get_rank()
            root = f"{tag}dcp_global_n{world_size}"
            async_save = False
        else:
            self._proc = 0
            root = f"{tag}dcp_r{self.rank}_n{world_size}"
            # DCP's note on every call without a process group, from the
            # worker thread too
            warnings.filterwarnings(
                "ignore", category=UserWarning,
                message="torch.distributed is disabled, unavailable or "
                        "uninitialized")
        self.checkpoint_path = os.path.join(self.directory, root)
        self._best = os.path.join(self.checkpoint_path, "best")
        os.makedirs(self._best, exist_ok=True)
        self._pool = (concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="dcp-save")
            if async_save else None)
        self._pending: concurrent.futures.Future | None = None
        # one entry a save: its step, the seconds of the host copy
        # (all a save holds the caller when asynchronous), the seconds of
        # the write (DCP, the rename and retention; in the worker thread
        # when asynchronous, else the caller's too) and the bytes of the
        # tensors this process wrote
        self.history: list[dict] = []

    @property
    def saves_global_state(self) -> bool:
        """True when the processes save one shared checkpoint, each its
        own rank rows (several processes)."""
        return self._multi

    # -- the step directories ---------------------------------------------

    def path_for_epoch(self, epoch_id: int | None) -> str:
        return os.path.join(self.checkpoint_path,
                            str(0 if epoch_id is None else epoch_id))

    @staticmethod
    def _steps(root: str) -> list[int]:
        """Finished saves under ``root``, oldest first."""
        try:
            names = os.listdir(root)
        except OSError:
            return []
        return sorted(int(n) for n in names if n.isdigit() and os.path.isfile(
            os.path.join(root, n, ".metadata")))

    def latest_step(self, best: bool = False) -> int | None:
        steps = self._steps(self._best if best else self.checkpoint_path)
        return steps[-1] if steps else None

    def exists(self) -> bool:
        return self.latest_step() is not None

    def discover_worlds(self) -> list[int]:
        """World sizes of other DCP roots in the directory."""
        pat = re.compile(re.escape(self.tag) + _ROOT_RE)
        worlds = {int(m.group(1)) for f in os.listdir(self.directory)
                  if (m := pat.match(f))}
        worlds.discard(self.world_size)
        return sorted(worlds)

    def refuse_other_worlds(self) -> None:
        """``NotImplementedError`` when the directory holds a DCP
        checkpoint of another world size: this backend is not
        resharded."""
        worlds = self.discover_worlds()
        if worlds:
            raise NotImplementedError(
                f"cross-world resume: {self.directory} holds --ckpt_backend "
                f"orbax (torch.distributed.checkpoint) checkpoints of world "
                f"{worlds}, not {self.world_size}; the reshard reads the "
                "per-rank files of --ckpt_backend msgpack, not this backend")

    # -- save ---------------------------------------------------------------

    def _split(self, key: str) -> int | None:
        """The dim (after the rank dim) tp splits leaf ``key`` on, or
        None."""
        if self.layout is None or self.layout.tp == 1:
            return None
        from ..parallel.tp import split_dim

        return split_dim(key)

    def _staged(self, key: str) -> bool:
        """Whether leaf ``key`` is a pipeline stage leaf, held ``[R, 1,
        L/pp, ...]``."""
        return (self.layout is not None and self.layout.pp > 1
                and key.startswith("stack."))

    def _stage(self, state) -> dict:
        """Host copies of the state's tensors; under several processes
        each a DTensor of this process's rows (``Shard(0)``, or on the
        ``(dp, ep, sp, tp)`` mesh as the module docstring says)."""
        def copy(t):
            return t.detach().to("cpu", copy=True).contiguous()

        tree = _map(_to_tree(state), copy)
        if not self._multi:
            return tree
        from torch.distributed.tensor import DTensor, Replicate, Shard

        from ..parallel.ep import is_expert

        def place(key, t):
            d = self._split(key)
            expert = self.layout is not None and self.layout.ep > 1 and (
                is_expert(key))
            staged = self._staged(key)
            e_dim = 2 if staged else 1
            if self.layout is None:
                places, shape = [Shard(0)], [t.shape[0] * self._mesh.size()]
            else:
                # (dp, pp, ep, sp, tp): rows over dp, over pp copies or
                # the layer dim's stages, over ep copies or the expert
                # dim's shards, copies over sp, and over tp copies or the
                # split dim's shards
                places = [Shard(0), Shard(1) if staged else Replicate(),
                          Shard(e_dim) if expert else Replicate(),
                          Replicate(),
                          Replicate() if d is None else Shard(d + 1)]
                if d is not None or staged:
                    t = t[:, 0]
                shape = [t.shape[0] * self.layout.dp]
            shape += t.shape[1:]
            if d is not None:
                shape[d + 1] *= self.layout.tp
            if staged:
                shape[1] *= self.layout.pp
            if expert:
                shape[e_dim] *= self.layout.ep
            stride = [1] * len(shape)
            for i in range(len(shape) - 2, -1, -1):
                stride[i] = stride[i + 1] * shape[i + 1]
            return DTensor.from_local(t, self._mesh, places,
                                      run_check=False,
                                      shape=torch.Size(shape),
                                      stride=tuple(stride))
        return _map_named(tree, place)

    def _dcp_kw(self) -> dict:
        return ({"process_group": self._group} if self._multi
                else {"no_dist": True})

    def _barrier(self) -> None:
        if self._multi:
            import torch.distributed as dist

            dist.barrier(group=self._group)

    def _write(self, payload: dict, step: int, roots: list[str],
               entry: dict) -> None:
        import torch.distributed.checkpoint as dcp

        t0 = time.perf_counter()
        for root, keep in zip(roots, (self.max_to_keep, 1)):
            tmp = os.path.join(root, f".tmp.{step}")
            if self._proc == 0:
                shutil.rmtree(tmp, ignore_errors=True)
            self._barrier()
            dcp.save(payload, checkpoint_id=tmp, **self._dcp_kw())
            if self._proc == 0:
                final = os.path.join(root, str(step))
                shutil.rmtree(final, ignore_errors=True)
                os.replace(tmp, final)
                for old in self._steps(root)[:-keep]:
                    shutil.rmtree(os.path.join(root, str(old)),
                                  ignore_errors=True)
            self._barrier()
        entry["write_s"] = time.perf_counter() - t0

    def save(self, state, meta: dict, epoch_id: int | None = None,
             is_best: bool = False) -> str:
        """Save ``state`` (the held rows) with ``meta`` as step
        ``epoch_id`` (default: the meta's epoch); returns the step's
        directory.  Asynchronous in one process: the call returns once
        the host copy is made."""
        step = int(meta.get("epoch", 0)) if epoch_id is None else int(
            epoch_id)
        self.wait()
        t0 = time.perf_counter()
        tree = self._stage(state)
        entry = {"step": step, "stage_s": time.perf_counter() - t0,
                 "bytes": 0}

        def count(t):
            local = t.to_local() if hasattr(t, "to_local") else t
            entry["bytes"] += local.numel() * local.element_size()
        _map(tree, count)
        payload = {"state": tree, "meta": json.dumps(
            dict(meta, is_best=bool(is_best)), default=float)}
        roots = [self.checkpoint_path] + ([self._best] if is_best else [])
        self.history.append(entry)
        if self._pool is not None:
            self._pending = self._pool.submit(self._write, payload, step,
                                              roots, entry)
        else:
            self._write(payload, step, roots, entry)
        return self.path_for_epoch(step)

    def wait(self) -> None:
        """Block until the save in flight (if any) has landed; its error,
        if it failed, is raised here."""
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    def close(self) -> None:
        """Land the save in flight and free the worker thread and, under
        several processes, the gloo group (every process calls it)."""
        self.wait()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        if self._group is not None:
            import torch.distributed as dist

            if self._group is not dist.group.WORLD:
                dist.destroy_process_group(self._group)
            self._group = self._mesh = None

    # -- restore ------------------------------------------------------------

    def _restore_from(self, best: bool, template):
        self.wait()
        step = self.latest_step(best)
        root = self._best if best else self.checkpoint_path
        if step is None:
            raise FileNotFoundError(f"no DCP checkpoint under {root}")
        import torch.distributed.checkpoint as dcp

        payload = {"state": self._stage(template), "meta": ""}
        dcp.load(payload, checkpoint_id=os.path.join(root, str(step)),
                 **self._dcp_kw())
        def local(key, t):
            t = t.to_local() if hasattr(t, "to_local") else t
            return (t if self._split(key) is None and not self._staged(key)
                    else t[:, None])
        tree = _map_named(payload["state"], local)
        meta = json.loads(payload["meta"]) or {}
        meta.pop("is_best", None)
        return _from_tree(template, tree), meta

    def restore(self, template) -> tuple[object, dict]:
        """The latest step, in ``template``'s structure (the same run
        configuration), and its meta."""
        return self._restore_from(False, template)

    def restore_best(self, template) -> tuple[object, dict]:
        """The best-so-far save (the reference's model_best files)."""
        return self._restore_from(True, template)
