"""DistributeTranspiler — program rewriting for parameter-server training
(port of paddle_tpu/transpiler/__init__.py; `collective` is the dp
gradient sync).

Parity: python/paddle/fluid/transpiler/distribute_transpiler.py (:271
transpile, :576 get_trainer_program, :735 get_pserver_program).  The
reference rewrites the program with send/recv/ListenAndServ ops and
slices every parameter across pservers.  The JAX package's split, which
the port keeps: DENSE parameters stay on the device and train inside the
step (replicated or all-reduced), while SPARSE embedding tables move to
the PS data plane (distributed/ps.py + csrc/ps_shard.cpp).  transpile()
therefore:

  1. finds `lookup_table(_v2)` ops flagged is_sparse / is_distributed,
  2. deletes them from the trainer program; their output becomes a
     pull-fed variable (the recv side),
  3. rewires every BackwardSection: the table weight leaves the
     differentiated set, the lookup output joins it (its @GRAD is what a
     Downpour worker pushes),
  4. drops the weight's optimizer ops and startup initializer (the PS
     shard owns both init and update — adagrad-in-push),
  5. attaches `_ps_sparse_config` to the trainer program, which
     Executor.train_from_dataset reads to run the pull -> step -> push
     loop (`table.pull(ids)` fed as the lookup output, the step
     fetching its `@GRAD`, `table.push(ids, grad)`); a caller may also
     drive it by hand.

get_pserver_program(endpoint) returns the serving handle for that
endpoint (the ListenAndServ analogue).
"""

from . import collective  # noqa: F401
from ..distributed.ps import (PSServer, ShardedPSClient, SparseEmbedding,
                              _host)


class DistributeTranspilerConfig:
    """Parity: transpiler/distribute_transpiler.py DistributeTranspilerConfig
    (slice_var_up et al. are N/A: dense vars are not sliced by design)."""

    def __init__(self):
        self.sync_mode = True
        self.geo_sgd_mode = False
        self.geo_sgd_need_push_nums = 100
        # PS-side optimizer applied in push (csrc shard supports
        # sgd/adagrad), and the table learning rate
        self.ps_optimizer = "adagrad"
        self.ps_lr = 0.05
        # shards per in-process table when no TCP endpoints are given
        self.local_shards = 4
        # where the bound tables' pulled rows go (None: the card)
        self.device = None


class _SaltedTable:
    """Disjoint id spaces for multiple tables sharing one PS cluster:
    id -> id * n_tables + index (int64 headroom is ample for vocab ids).
    The reference separates tables by table_id in its PS protocol; the
    salt plays that role over the single-table shard servers."""

    def __init__(self, client, index, n_tables):
        self._client = client
        self._index = index
        self._n = n_tables

    def _salt(self, ids):
        import numpy as np

        return _host(ids, np.int64) * self._n + self._index

    def pull(self, ids):
        return self._client.pull(self._salt(ids))

    def push(self, ids, grads):
        self._client.push(self._salt(ids), grads)

    def close(self):
        self._client.close()


class PServerHandle:
    """One endpoint's serving side (ListenAndServ analogue): hosts its
    modulo-shard of every distributed table."""

    def __init__(self, endpoint, dim, optimizer, lr):
        self.endpoint = endpoint
        self.dim = dim
        self._optimizer = optimizer
        self._lr = lr
        self._server = None

    def start(self):
        host, port = self.endpoint.rsplit(":", 1)
        self._server = PSServer(dim=self.dim, host=host, port=int(port),
                                optimizer=self._optimizer,
                                lr=self._lr).start()
        return self._server

    @property
    def port(self):
        return self._server.port if self._server else None

    def stop(self):
        if self._server is not None:
            self._server.stop()
            self._server = None


class DistributeTranspiler:
    def __init__(self, config=None):
        self.config = config or DistributeTranspilerConfig()
        self._trainer_program = None
        self._startup_program = None
        self._entries = []
        self._endpoints = []

    # -- analysis + rewrite ----------------------------------------------

    def transpile(self, trainer_id, program=None, pservers="", trainers=1,
                  sync_mode=None, startup_program=None):
        from ..framework.program import default_main_program, \
            default_startup_program

        program = program if program is not None else default_main_program()
        if startup_program is None:
            try:
                startup_program = default_startup_program()
            except Exception:
                startup_program = None
        if sync_mode is not None:
            self.config.sync_mode = sync_mode
        self.trainer_id = trainer_id
        self.trainers = trainers
        self._endpoints = [e for e in pservers.split(",") if e]

        # the reference transpiler mutates the program in place, so the
        # common idiom "transpile(); run(default_main_program())" works
        trainer = program
        block = trainer.global_block()

        sparse_ops = [
            op for op in block.ops
            if op.type in ("lookup_table", "lookup_table_v2")
            and (op.attrs.get("is_sparse") or op.attrs.get("is_distributed"))
        ]
        self._entries = []
        removed_ws = set()
        for op in sparse_ops:
            ids_name = self._slot_name(op, "Ids")
            w_name = self._slot_name(op, "W")
            out_name = self._slot_name(op, "Out", outputs=True)
            w_var = block.var(w_name)
            dim = int(w_var.shape[-1])
            self._entries.append({
                "ids_var": ids_name, "emb_var": out_name,
                "w_name": w_name, "dim": dim,
            })
            removed_ws.add(w_name)
            self._remove_op(trainer, block, op)
            # the pull-fed variable is a leaf now
            block.var(out_name).stop_gradient = False

        # weight leaves the trainer entirely: not persistable (no init
        # demanded), not a trainable program parameter
        for w in removed_ws:
            v = block.var(w)
            v.persistable = False
            if hasattr(v, "trainable"):
                v.trainable = False

        # optimizer ops updating a removed weight go away (the PS shard
        # applies its own update in push)
        for op in [o for o in block.ops
                   if self._slot_name(o, "Param") in removed_ws]:
            self._remove_op(trainer, block, op)

        # backward sections: swap w -> lookup output in the param list
        for sec in getattr(trainer, "backward_sections", []):
            params = [p for p in sec.param_names if p not in removed_ws]
            for e in self._entries:
                if e["emb_var"] not in params:
                    params.append(e["emb_var"])
            sec.param_names = params
        trainer._bump()

        # startup: drop initializer ops for removed weights (in place)
        if startup_program is not None:
            sb = startup_program.global_block()
            sb.ops[:] = [
                op for op in sb.ops
                if not (set(op.output_names()) & removed_ws)
            ]
            startup_program._bump()
            self._startup_program = startup_program
        else:
            self._startup_program = None

        dims = {e["dim"] for e in self._entries}
        if self._endpoints and len(dims) > 1:
            raise ValueError(
                "TCP pserver mode hosts one table width per endpoint set; "
                f"got dims {sorted(dims)} — use separate clusters or the "
                "in-process mode (pservers='')")
        self._dim = dims.pop() if dims else 0

        # bind the runtime tables the executor will pull/push through —
        # ONE table per distinct weight (tied embeddings share a table;
        # distinct weights never alias rows)
        distinct_ws = []
        for e in self._entries:
            if e["w_name"] not in distinct_ws:
                distinct_ws.append(e["w_name"])
        tables_by_w = {}
        if self._entries:
            if self._endpoints:
                client = ShardedPSClient(self._endpoints, self._dim,
                                         device=self.config.device)
                self._client = client
                for i, w in enumerate(distinct_ws):
                    # disjoint id spaces on the shared servers: salt ids
                    # by table index (the reference namespaces by table_id
                    # in the PS protocol)
                    tables_by_w[w] = _SaltedTable(client, i,
                                                  len(distinct_ws))
            else:
                for w in distinct_ws:
                    dim = next(e["dim"] for e in self._entries
                               if e["w_name"] == w)
                    tables_by_w[w] = SparseEmbedding(
                        dim=dim, num_shards=self.config.local_shards,
                        optimizer=self.config.ps_optimizer,
                        lr=self.config.ps_lr, device=self.config.device)
            for e in self._entries:
                e["table"] = tables_by_w[e["w_name"]]
        trainer._ps_sparse_config = list(self._entries)
        self._trainer_program = trainer
        return self

    @staticmethod
    def _remove_op(program, block, op):
        """Delete an op, shifting every BackwardSection position recorded
        after it (sections address op indices)."""
        idx = block.ops.index(op)
        del block.ops[idx]
        for sec in getattr(program, "backward_sections", []):
            if sec.pos > idx:
                sec.pos -= 1
        program._bump()   # invalidate the executor's run-plan cache

    @staticmethod
    def _slot_name(op, slot, outputs=False):
        d = op.outputs if outputs else op.inputs
        v = d.get(slot)
        if v is None:
            return None
        if isinstance(v, (list, tuple)):
            v = v[0] if v else None
        return getattr(v, "name", v)

    # -- artifacts --------------------------------------------------------

    def get_trainer_program(self):
        if self._trainer_program is None:
            raise RuntimeError("call transpile() first")
        return self._trainer_program

    def get_startup_program(self, endpoint=None, pserver_program=None):
        if self._startup_program is None:
            raise RuntimeError("transpile() was not given a startup program")
        return self._startup_program

    def get_pserver_program(self, endpoint):
        """Serving handle for one endpoint (reference :735 returns the
        ListenAndServ program; here the server loop IS the program)."""
        if endpoint not in self._endpoints:
            raise ValueError(f"unknown pserver endpoint {endpoint!r}; "
                             f"transpiled with {self._endpoints}")
        return PServerHandle(endpoint, self._dim,
                             self.config.ps_optimizer, self.config.ps_lr)

    def get_pserver_programs(self, endpoint):
        return self.get_pserver_program(endpoint), \
            self.get_startup_program(endpoint)

    @property
    def tables(self):
        """The bound runtime tables (one per rewritten lookup)."""
        return [e.get("table") for e in self._entries]

    @property
    def client(self):
        """The shared ShardedPSClient in TCP mode (None in-process)."""
        return getattr(self, "_client", None)


def memory_optimize(input_program, skip_opt_set=None, print_log=False,
                    level=0, skip_grads=True):
    """Reference transpiler/memory_optimization_transpiler.py — a
    legacy inplace/memory-reuse pass, deprecated in the reference; torch's
    caching allocator owns buffer reuse here.  A no-op kept for 1.x
    script parity."""
    return None


def release_memory(input_program, skip_opt_set=None):
    """See memory_optimize: the allocator owns buffer lifetime; no-op
    parity."""
    return None


class HashName:
    """PS endpoint dispatch policy (reference ps_dispatcher.py:60):
    hash(var name) % #pservers."""

    def __init__(self, pserver_endpoints):
        self._eps = list(pserver_endpoints)

    def dispatch(self, varlist):
        return [self._eps[hash(v.name if hasattr(v, "name") else v)
                          % len(self._eps)] for v in varlist]

    def reset(self):
        pass


class RoundRobin:
    """PS endpoint dispatch policy (reference ps_dispatcher.py:93):
    cycling assignment."""

    def __init__(self, pserver_endpoints):
        self._eps = list(pserver_endpoints)
        self._i = 0

    def dispatch(self, varlist):
        out = []
        for v in varlist:
            out.append(self._eps[self._i])
            self._i = (self._i + 1) % len(self._eps)
        return out

    def reset(self):
        self._i = 0


__all__ = ["collective", "DistributeTranspiler", "DistributeTranspilerConfig",
           "PServerHandle", "HashName", "RoundRobin", "memory_optimize",
           "release_memory"]
