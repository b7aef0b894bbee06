"""Ranks of ``gloo`` process groups on the CPU for the port's parallel tests.

``run_ranks(fn, world, *args)`` spawns ``world`` processes on localhost,
each of which joins a ``gloo`` group, runs ``fn(rank, world, *args)`` with
one thread and hands back its result.  The workers below import torch and
the port only (no JAX), so a spawned process starts quickly; the tests
compute the JAX references in their own process.
"""

from __future__ import annotations

import datetime
import os
import socket
import tempfile

import torch


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, fn, world, port, out_dir, args):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=240))
    try:
        out = fn(rank, world, *args)
        torch.save(out, os.path.join(out_dir, f"{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, *args):
    """``[fn(r, world, *args) for r in range(world)]``, each in its own
    process of one ``gloo`` group."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as out_dir:
        mp.start_processes(_entry, args=(fn, world, free_port(), out_dir, args), nprocs=world, join=True,
                           start_method="spawn")
        return [torch.load(os.path.join(out_dir, f"{r}.pt"), weights_only=False) for r in range(world)]


# --------------------------------------------------------------------------
# The collectives of parallel/comm.py.


def collectives(rank, world):
    """Each collective on rank-dependent inputs: its result on this rank,
    and the gradient each differentiable one hands back."""
    from flyp_tpu_torch.parallel import comm
    from flyp_tpu_torch.parallel.mesh import MeshConfig, create_mesh

    group = create_mesh(MeshConfig(data=world)).group("data")
    x = torch.arange(2 * world * 3, dtype=torch.float32).reshape(2 * world, 3) * (rank + 1)
    out = {
        "host_group": comm.host_group(),
        "sum": comm.all_reduce_(x.clone(), group),
        "max": comm.all_reduce_(x.clone() - 10 * rank, group, op="max"),
        "gather0": comm.all_gather(x[:2], group, dim=0),
        "gather1": comm.all_gather(x[:2], group, dim=1),
        "scatter": comm.reduce_scatter(x, group),
        "flat": comm.all_reduce_flat([x, x[0, :2], x.t()], group, bucket_elements=8),
        "max_int": comm.max_int(5 + 3 * rank),
    }
    rows = x[:2].clone().requires_grad_(True)
    gathered = comm.gather_rows(rows, group)
    out["gather_rows_grad"] = torch.autograd.grad((gathered * gathered).sum(), rows)[0]
    y = x[:2].clone().requires_grad_(True)
    out["reduce_grad"] = torch.autograd.grad(comm.reduce_from_group(y, group).sum() * (rank + 1), y)[0]
    z = x[:2].clone().requires_grad_(True)
    out["copy_grad"] = torch.autograd.grad(comm.copy_to_group(z, group).sum() * (rank + 1), z)[0]
    w = x[:2].clone().requires_grad_(True)
    whole = comm.gather_shards(w, group, 1)
    out["gather_shards"] = whole.detach()
    out["gather_shards_grad"] = torch.autograd.grad((whole * whole).sum(), w)[0]
    return out


# --------------------------------------------------------------------------
# The TP attention block (test (a)).


def tp_block(rank, world, arrays, cot, heads, causal, train):
    """One head shard of the attention block on each rank: its output and
    the grads of the seven inputs (x, LN, shard weights, bout)."""
    from flyp_tpu_torch.ops.attention_block import tp_attention_block
    from flyp_tpu_torch.parallel.mesh import MeshConfig, create_mesh

    mesh = create_mesh(MeshConfig(data=1, model=world))
    x, ln_s, ln_b, wqkv, bqkv, wout, bout = (torch.from_numpy(a) for a in arrays)
    Dv = wqkv.shape[-1] // world
    cols = slice(rank * Dv, (rank + 1) * Dv)
    inputs = [t.clone().requires_grad_(True) for t in
              (x, ln_s, ln_b, wqkv[:, :, cols], bqkv[:, cols], wout[cols], bout)]
    out = tp_attention_block(*inputs, heads // world, causal, group=mesh.group("model"), train=train)
    grads = torch.autograd.grad(out, inputs, torch.from_numpy(cot))
    return out.detach().numpy(), [g.numpy() for g in grads]


# --------------------------------------------------------------------------
# The gathered contrastive loss (test (b)).


def gathered_loss(rank, world, img, txt, scale, labels, variants):
    """Per variant: this rank's per-item losses (or the scalar) and the
    grads of its feature rows and of logit_scale (summed over the ranks),
    with the train step's objective (its rows' share of the global mean)."""
    from flyp_tpu_torch.ops.losses import clip_loss
    from flyp_tpu_torch.parallel import comm
    from flyp_tpu_torch.parallel.mesh import MeshConfig, create_mesh, shard_batch

    mesh = create_mesh(MeshConfig(data=world))
    group = mesh.group("data")
    out = {}
    for name, kw in variants.items():
        kw = dict(kw)
        lab = None
        if kw.pop("labels", False):
            lab = torch.from_numpy(shard_batch(mesh, labels))
        i, t = (torch.from_numpy(shard_batch(mesh, a)).requires_grad_(True) for a in (img, txt))
        s = torch.tensor(scale, requires_grad=True)
        loss = clip_loss(i, t, s, lab, group=group, **kw)
        if loss.dim() == 0:
            objective = loss / world
        else:
            b_global = img.shape[0]
            objective = loss.sum() / b_global if loss.shape[0] != b_global else loss.mean() / world
        gi, gt, gs = torch.autograd.grad(objective, (i, t, s))
        gs = comm.all_reduce_(gs.clone(), group)
        out[name] = (loss.detach().numpy(), gi.numpy(), gt.numpy(), float(gs))
    return out


# --------------------------------------------------------------------------
# Train steps on meshes (test (d)).


def _place(mesh, state, fsdp):
    from flyp_tpu_torch.parallel.fsdp import shard_train_state_fsdp
    from flyp_tpu_torch.parallel.tp import shard_train_state

    if mesh.shape["model"] > 1:
        return shard_train_state(mesh, state)
    if fsdp:
        return shard_train_state_fsdp(mesh, state)
    state.mesh = mesh
    return state


def mesh_steps(rank, world, config, state_dict, batch, layouts, schedule, steps):
    """Per layout ``name -> (MeshConfig kwargs, fsdp)``: ``steps`` train steps
    on this rank's rows, then the whole parameters; rank 0 returns each
    layout's losses, grad norms, parameters and the shard shapes it held."""
    from flyp_tpu_torch.models import CLIPModel
    from flyp_tpu_torch.parallel.mesh import MeshConfig, create_mesh, shard_batch
    from flyp_tpu_torch.training import create_train_state, make_optimizer, make_train_step, warmup_cosine_lr
    from flyp_tpu_torch.utils.checkpoint import gather_state

    out = {}
    for name, (mesh_kwargs, fsdp) in layouts.items():
        mesh = create_mesh(MeshConfig(**mesh_kwargs))
        model = CLIPModel(config)
        model.load_state_dict(state_dict, strict=True)
        opt = make_optimizer(warmup_cosine_lr(*schedule), weight_decay=0.1)
        state = _place(mesh, create_train_state(model, opt), fsdp)
        held = {n: tuple(p.shape) for n, p in zip((n for n, _ in model.named_parameters()),
                                                    state.update_targets)}
        moments = {n: tuple(m.shape) for (n, _), m in zip(model.named_parameters(), state.opt_state.mu)}
        step = make_train_step(model, opt, mesh=mesh, log_grad_norm=True)
        images, tokens = (torch.from_numpy(a) for a in shard_batch(mesh, batch))
        losses, norms = [], []
        for _ in range(steps):
            state, m = step(state, images, tokens)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        params, _, _ = gather_state(state)
        if rank == 0:
            out[name] = dict(losses=losses, norms=norms, params={k: v.numpy() for k, v in params.items()},
                             held=held, moments=moments, layout=dict(state.layout))
    return out


# --------------------------------------------------------------------------
# The trainer through cli/main.py (test (e)).


def cli_runs(rank, world, runs, config, state_dict, cwd):
    """Each ``(name, argv)`` of ``runs`` through ``cli_main.main`` in turn,
    the model built as ``config`` with ``state_dict``; returns the files
    each rank wrote to checkpoints (by name) and the runs' return values."""
    from flyp_tpu_torch.cli import main as cli_main
    from flyp_tpu_torch.models import CLIPModel, factory
    from flyp_tpu_torch.utils import checkpoint

    os.chdir(cwd)

    def build(cfg, device="cuda", **_):
        model = CLIPModel(config)
        model.load_state_dict(state_dict, strict=True)
        return model.to(device).eval().requires_grad_(False)

    factory.build_clip_model = build
    written = []
    real_write = checkpoint._write_checkpoint_dir

    def write(path, files, meta):
        written.append(os.path.basename(path))
        return real_write(path, files, meta)

    checkpoint._write_checkpoint_dir = write
    rets = {}
    for name, argv in runs:
        if name == NO_GRAD_SUM:
            rets[name] = without_grad_sum(lambda: cli_main.main(cli_main.parse_main_arguments(argv)))
        else:
            rets[name] = cli_main.main(cli_main.parse_main_arguments(argv))
    return dict(written=written, rets=rets)


#: A planted fault: data parallelism whose gradient sum over ranks is
#: skipped, so each rank steps on its own rows' share of the gradient.
NO_GRAD_SUM = "dp_no_grad_sum"


def without_grad_sum(fn):
    """``fn()`` with ``comm.all_reduce_flat`` (the data-parallel gradient
    sum) returning each rank's own tensors."""
    from flyp_tpu_torch.parallel import comm

    real = comm.all_reduce_flat
    comm.all_reduce_flat = lambda tensors, group, *a, **k: [t.clone() for t in tensors]
    try:
        return fn()
    finally:
        comm.all_reduce_flat = real


def suite(rank, world, jobs):
    """Several workers in one process group, in order: ``jobs`` is a list of
    ``(key, worker name, args)``; returns ``{key: result}``."""
    return {key: globals()[name](rank, world, *args) for key, name, args in jobs}


# --------------------------------------------------------------------------
# A transformer block on the TP routes (test (a)).


def _seeded_block(impl, train):
    from flyp_tpu_torch.models.layers import ResidualBlock
    from flyp_tpu_torch.ops import attention as dispatch

    os.environ[dispatch._IMPL_ENV] = impl
    dispatch._default_impl.cache_clear()
    gen = torch.Generator().manual_seed(7)
    block = ResidualBlock(256, 4, causal=True)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * (0.05 if p.dim() > 1 else 0.1))
    block.train(train)
    x = torch.randn(2, 9, 256, generator=gen)
    cot = torch.randn(2, 9, 256, generator=gen)
    return block, x, cot


def _block_grads(block, x, cot):
    x = x.clone().requires_grad_(True)
    names = [n for n, _ in block.named_parameters()]
    out = block(x)
    grads = torch.autograd.grad(out, [x, *block.parameters()], cot)
    return out.detach().numpy(), {"x": grads[0].numpy(), **{n: g.numpy() for n, g in zip(names, grads[1:])}}


def whole_block(impl, train):
    """The seeded block whole, in this process: output and grads.  The
    route's environment variable is restored after."""
    from flyp_tpu_torch.ops import attention as dispatch

    saved = os.environ.get(dispatch._IMPL_ENV)
    try:
        block, x, cot = _seeded_block(impl, train)
        return _block_grads(block, x, cot)
    finally:
        if saved is None:
            os.environ.pop(dispatch._IMPL_ENV, None)
        else:
            os.environ[dispatch._IMPL_ENV] = saved
        dispatch._default_impl.cache_clear()


def tp_residual_block(rank, world, impl, train):
    """The seeded block sharded over the model axis of ``world`` ranks on
    route ``impl``: output, grads (of x and this rank's parameters) and the
    layout."""
    from flyp_tpu_torch.parallel.mesh import MeshConfig, create_mesh
    from flyp_tpu_torch.parallel.tp import shard_params

    block, x, cot = _seeded_block(impl, train)
    layout = shard_params(create_mesh(MeshConfig(data=1, model=world)), block)
    out, grads = _block_grads(block, x, cot)
    return out, grads, layout


# --------------------------------------------------------------------------
# The rest of the parallel layer (tests/test_torch_parallel_a9b.py).


def synced_batch_norm(rank, world, x, scale, bias, mean, var, cot):
    """The BatchNorm layer over ``world`` ranks of this group, each its
    rows of the float64 batch ``x`` (NHWC): output, the grads of x, scale
    and bias, and the running statistics; then the same with the
    backward's sum over the group left out (the transpose taken as the
    identity, a planted fault)."""
    from flyp_tpu_torch.models import resnet
    from flyp_tpu_torch.parallel.mesh import MeshConfig, create_mesh, shard_batch

    mesh = create_mesh(MeshConfig(data=world))
    group = mesh.group("data")
    xs, gs = (torch.from_numpy(shard_batch(mesh, a)).permute(0, 3, 1, 2) for a in (x, cot))
    out = {}
    for name in ("sound", "identity_transpose"):
        bn = resnet.TorchBatchNorm(x.shape[-1]).double()
        with torch.no_grad():
            for t, v in ((bn.scale, scale), (bn.bias, bias), (bn.mean, mean), (bn.var, var)):
                t.copy_(torch.from_numpy(v))
        xr = xs.clone().requires_grad_(True)
        with resnet.synced_batch_norm(bn, group):
            y = bn(xr)
        real = resnet.all_reduce_
        if name == "identity_transpose":
            resnet.all_reduce_ = lambda t, group, op="sum": t
        try:
            grads = torch.autograd.grad(y, [xr, bn.scale, bn.bias], gs)
        finally:
            resnet.all_reduce_ = real
        out[name] = dict(y=y.detach().permute(0, 2, 3, 1).numpy(), dx=grads[0].permute(0, 2, 3, 1).numpy(),
                         dscale=grads[1].numpy(), dbias=grads[2].numpy(), mean=bn.mean.numpy(), var=bn.var.numpy())
    return out


class SGD:
    """Plain SGD with the port optimizer's interface (``p - lr g`` for each
    parameter not frozen), as tests/test_torch_grad_cache.py's, with
    unused moments for the placements to cut."""

    def __init__(self, lr: float):
        self.lr = lr

    def init(self, params):
        from flyp_tpu_torch.training.train_state import AdamWState

        # Zero moments the FSDP and TP placements can cut like AdamW's.
        params = list(params)
        return AdamWState(count=torch.zeros((), dtype=torch.int32), mu=[torch.zeros_like(p) for p in params],
                          nu=[torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def update(self, params, grads, state, frozen=None):
        for i, (p, g) in enumerate(zip(params, grads)):
            if not (frozen and frozen[i]):
                p.copy_(p - self.lr * g)
        state.count.add_(1)
        return torch.tensor(self.lr)


#: A planted fault of the chunked step on a mesh: no re-layout, so each
#: rank's chunk i is its own block's i-th piece, not its 1/n of the global
#: chunk i.
CONTIGUOUS_CHUNKS = "contiguous_chunks"


def a9b_steps(rank, world, cases):
    """Per case ``name -> dict(config, state_dict, batch, mesh, fsdp, impl,
    chunks, sgd, schedule, steps, fault)``: ``steps`` train steps of the
    port on this rank's rows of ``batch`` on the mesh; returns each case's
    losses, grad norms, this rank's per-item losses and running statistics,
    and (rank 0) the whole parameters after."""
    from flyp_tpu_torch.models import CLIPModel
    from flyp_tpu_torch.ops import attention as dispatch
    from flyp_tpu_torch.parallel import comm
    from flyp_tpu_torch.parallel.mesh import MeshConfig, create_mesh, shard_batch
    from flyp_tpu_torch.training import create_train_state, grad_cache, make_optimizer, make_train_step
    from flyp_tpu_torch.training import warmup_cosine_lr
    from flyp_tpu_torch.utils.checkpoint import gather_state

    out = {}
    for name, c in cases.items():
        os.environ[dispatch._IMPL_ENV] = c.get("impl", "xla")
        dispatch._default_impl.cache_clear()
        mesh = create_mesh(MeshConfig(**c["mesh"]))
        model = CLIPModel(c["config"])
        model.load_state_dict(c["state_dict"], strict=True)
        opt = SGD(c["sgd"]) if c.get("sgd") else make_optimizer(warmup_cosine_lr(*c["schedule"]), weight_decay=0.1)
        state = _place(mesh, create_train_state(model, opt), c.get("fsdp", False))
        step = make_train_step(model, opt, mesh=mesh, log_grad_norm=True, grad_cache_chunks=c.get("chunks", 1))
        images, tokens = (torch.from_numpy(a) for a in shard_batch(mesh, c["batch"]))
        real = grad_cache.chunk_rows, grad_cache.global_rows, grad_cache.own_rows
        if c.get("fault") == CONTIGUOUS_CHUNKS:
            grad_cache.chunk_rows = lambda x, group, chunks: x
            grad_cache.global_rows = lambda x, group, chunks: comm.all_gather(x, group)
            grad_cache.own_rows = lambda whole, group, chunks: whole.chunk(comm.group_size(group))[
                comm.group_rank(group)]
        try:
            losses, norms, per_item = [], [], []
            for _ in range(c["steps"]):
                state, m = step(state, images, tokens)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
                per_item.append(m["per_item_loss"].numpy())
        finally:
            grad_cache.chunk_rows, grad_cache.global_rows, grad_cache.own_rows = real
        params, _, _ = gather_state(state)
        out[name] = dict(losses=losses, norms=norms, per_item=per_item,
                         stats={k: v.numpy().copy() for k, v in model.named_buffers()},
                         params={k: v.numpy() for k, v in params.items()} if rank == 0 else None)
    dispatch._default_impl.cache_clear()
    return out


# --------------------------------------------------------------------------
# The CE ablation across ranks (tests/test_torch_research_ce.py).


def ce_ablation_runs(rank, world, runs):
    """Each run of ``runs`` (name, config fields, model config, state dict)
    through ``training/ce_ablation.py`` on this rank's rows: the model's
    state dict afterwards."""
    import logging

    from flyp_tpu_torch.config import ExperimentConfig
    from flyp_tpu_torch.models import CLIPModel
    from flyp_tpu_torch.training.ce_ablation import ce_ablation

    out = {}
    for name, fields, config, state_dict in runs:
        model = CLIPModel(config)
        model.load_state_dict(state_dict)
        ce_ablation(ExperimentConfig(**fields), logging.getLogger("ce_ablation_ranks"), model=model, print_every=1)
        out[name] = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return out
