"""SPMD sharded rendering over torch.distributed (port of
parallel/render_sharded.py).

One rank owns one device. The ranks form a 2D ("dp", "sp") DeviceMesh:

  * "dp": data parallel over film pixels (the analog of
    BlockedRenderProcess's blocks, renderproc.cpp:151): rank (i, j) renders
    the i-th contiguous range of pixel ids;
  * "sp": sample parallel over spp: rank (i, j) takes the samples
    [j spp/sp, (j+1) spp/sp) of every pixel of its range, and the partial
    sums meet in one all-reduce over "sp" (the EWorkResult messages of
    sched_remote.h:221-237 as a collective).

The sample stream is a pure function of (seed, pixel, sample), so the
sharded image is the single-device render's up to the order of the sums.
The shards form the sums the JAX package's shards form: its chunk formula
(not RenderConfig.resolve_chunk), pixel ids padded past the last pixel to
a multiple of dp, sample base sp_index * spp/sp. A non-box filter gives
every rank a full film, since splats spill across range edges; the films
and weights are summed over the whole group and then divided (the padded
ids are not rendered there, where the JAX package splats them: C45).
Every rank ends with the whole (H, W, 3) image, as the JAX out_specs give
it.

Collectives run on the group's backend: NCCL where every rank has a card
of its own, gloo where ranks share a card or run on the CPU; each rank
decides from its node's rank count, which the ranks exchange through the
rendezvous store before the group starts (`start_group`). Gloo's
collectives run on host copies of the tensors.
"""
from __future__ import annotations

import dataclasses
import socket
import urllib.parse

import torch
import torch.distributed as dist

from ..film import film as filmlib
from ..integrators.common import ChunkGraph, RenderConfig
# the shard sums are common.render's own loop over arbitrary pixel ids and
# sample ranges (the JAX package's names)
from ..integrators.common import film_sum as _film_sum
from ..integrators.common import radiance_sum as _radiance_sum
from ..utils import graphs


def rank_device(local_rank: int, cpu: bool = False) -> torch.device:
    """The device of a rank: the CPU under `cpu`, else the card
    cuda:(local_rank % device_count), local_rank being the rank's index
    among the group's ranks on its node (node_layout). Raises where there
    is no card."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"local rank {local_rank}: no CUDA device "
                           "(run on the CPU with cpu=True)")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def backend_for(local_world_size: int, cpu: bool = False) -> str:
    """NCCL where every rank of this node has a card of its own (the node's
    rank count local_world_size at most its card count), gloo where ranks
    share a card or run on the CPU (NCCL refuses two ranks on one device)."""
    if cpu:
        return "gloo"
    return "nccl" if local_world_size <= torch.cuda.device_count() else "gloo"


def node_layout(store, world_size: int, rank: int, node: str | None = None):
    """(local rank, local world size): this rank's index among the group's
    ranks on its node, and their count. Each rank publishes its node's name
    (the hostname, or `node`) in the rendezvous store and reads every
    rank's, so each decides from what it observes and the ranks of a node
    decide alike."""
    node = socket.gethostname() if node is None else node
    store.set(f"node/{rank}", node)
    nodes = [store.get(f"node/{r}").decode() for r in range(world_size)]
    peers = [r for r, name in enumerate(nodes) if name == node]
    return peers.index(rank), len(peers)


def start_group(init_method: str, world_size: int, rank: int, cpu: bool = False):
    """Start the default process group at init_method (tcp://HOST:PORT):
    the ranks meet in its store, each learns its node's layout
    (node_layout), selects its device and fixes the backend (backend_for),
    and only then does the group start, on that store. Returns (device,
    backend)."""
    url = urllib.parse.urlparse(init_method)
    if url.scheme != "tcp" or not url.hostname or not url.port:
        raise ValueError(f"start_group: expected tcp://HOST:PORT, got {init_method!r}")
    store = dist.TCPStore(url.hostname, url.port, world_size, is_master=rank == 0)
    local_rank, local_world = node_layout(store, world_size, rank)
    dev = rank_device(local_rank, cpu)
    backend = backend_for(local_world, cpu)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=store, world_size=world_size, rank=rank)
    return dev, backend


def make_mesh(n_devices: int | None = None, sp: int = 1, device="cuda"):
    """The ("dp", "sp") DeviceMesh over every rank of the started group,
    rank = dp_index * sp + sp_index (the JAX mesh's reshape(n // sp, sp)).
    On gloo the mesh is a CPU mesh whatever `device` is: gloo's
    collectives run on host copies (the renders stay on `device`)."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"make_mesh: {n} devices but the group has {world} ranks "
                         "(one rank a device)")
    if n % sp:
        raise ValueError(f"make_mesh: {n} devices do not split into sp={sp}")
    device_type = "cpu" if dist.get_backend() == "gloo" else torch.device(device).type
    return init_device_mesh(device_type, (n // sp, sp), mesh_dim_names=("dp", "sp"))


def _on_host(t: torch.Tensor, group) -> bool:
    return dist.get_backend(group) == "gloo" and t.device.type != "cpu"


def _all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of t over the group (gloo: through a host copy)."""
    x = t.cpu() if _on_host(t, group) else t.clone()
    dist.all_reduce(x, group=group)
    return x.to(t.device)


class _AllReduceSum(torch.autograd.Function):
    """A differentiable all-reduce (torch.distributed.nn.functional's, which
    torch 2.13 deprecates): the forward sums over the group, the backward
    sums the gradients over the group."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_reduce(t, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


def _all_reduce_grad(t: torch.Tensor, group=None) -> torch.Tensor:
    """_all_reduce under autograd."""
    return _AllReduceSum.apply(t, group)


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """The group's tensors concatenated along dim 0 in group-rank order."""
    n = dist.get_world_size(group)
    if dist.get_backend(group) == "gloo":
        parts = [torch.empty_like(t.cpu()) for _ in range(n)]
        dist.all_gather(parts, t.cpu().contiguous(), group=group)
        return torch.cat(parts).to(t.device)
    out = torch.empty((n * t.shape[0], *t.shape[1:]), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out


def _layout(scene, cam, cfg: RenderConfig, mesh):
    """(sp size, this rank's pixel ids on the scene's device, its sample
    base, its samples a pixel, chunk): the JAX package's choices (module
    note)."""
    ndp, nsp = mesh["dp"].size(), mesh["sp"].size()
    w, h = cam.width, cam.height
    if cfg.spp % nsp:
        raise ValueError(f"spp {cfg.spp} not divisible by sp={nsp}")
    spp_local = cfg.spp // nsp
    chunk = min(max(1, (1 << 19) // max(w * h // ndp, 1)), spp_local)
    while spp_local % chunk:
        chunk -= 1
    per = (w * h + (-(w * h) % ndp)) // ndp
    dp_i = mesh.get_local_rank("dp")
    pixel_ids = torch.arange(dp_i * per, (dp_i + 1) * per, dtype=torch.int64,
                             device=scene.device)
    return nsp, pixel_ids, mesh.get_local_rank("sp") * spp_local, spp_local, chunk


def _unpadded(pixel_ids, npix: int):
    """The ids of a film's pixels: the padding past the last pixel is not
    rendered into a filtered film (the JAX package splats it into the last
    rows, ROADMAP C45)."""
    return pixel_ids[pixel_ids < npix]


def render_sharded(scene, cam, li_fn, cfg: RenderConfig, mesh) -> torch.Tensor:
    """Full-frame render over the mesh -> (H, W, 3) on every rank.

    The box filter sums each pixel's samples on its rank; any other filter
    splats into per-rank full films summed over the whole group."""
    _, pixel_ids, base, spp_local, chunk = _layout(scene, cam, cfg, mesh)
    w, h = cam.width, cam.height
    if cfg.filter != filmlib.FILTER_BOX:
        img, wgt = _film_sum(scene, cam, li_fn, cfg, _unpadded(pixel_ids, w * h), base,
                             spp_local, chunk)
        return filmlib.develop(_all_reduce(img), _all_reduce(wgt))
    acc = _radiance_sum(scene, cam, li_fn, cfg, pixel_ids, base, spp_local, chunk)
    return _gather_box(acc, cam, cfg, mesh)


def _gather_box(acc, cam, cfg: RenderConfig, mesh) -> torch.Tensor:
    """The box film's image from each rank's pixel sums: summed over "sp",
    gathered over "dp"."""
    w, h = cam.width, cam.height
    acc = _all_reduce(acc, mesh.get_group("sp")) / float(cfg.spp)
    return _all_gather(acc, mesh.get_group("dp"))[:w * h].reshape(h, w, 3)


_SHARD_GRAPHS = graphs.Cache()


def render_sharded_jit(scene, cam, li_fn, cfg: RenderConfig, mesh) -> torch.Tensor:
    """`render_sharded`, compiled and cached as the JAX package's
    render_sharded_jit is. On the card each rank renders its shard's spp
    chunks over its own pixel ids through a chunk graph
    (integrators/common.ChunkGraph: the first chunk of a key eager, then
    captured and replayed), keyed by (li_fn, cfg, the mesh's shape and
    this rank's place in it, the scene's and camera's static_key); the
    all-reduce and all-gather run outside the graph (gloo's host copies
    cannot be captured). On the CPU this is `render_sharded`. A failed
    capture raises; a leaf that requires grad raises
    NotImplementedError."""
    graphs.refuse_grad("render_sharded_jit", scene, cam)
    if scene.device.type != "cuda":
        return render_sharded(scene, cam, li_fn, cfg, mesh)
    _, pixel_ids, base, spp_local, chunk = _layout(scene, cam, cfg, mesh)
    w, h = cam.width, cam.height
    box = cfg.filter == filmlib.FILTER_BOX
    place = (mesh["dp"].size(), mesh["sp"].size(), mesh.get_local_rank("dp"),
             mesh.get_local_rank("sp"))
    key = (li_fn, cfg, place, graphs.static_key(scene, cam))
    with _SHARD_GRAPHS.lock, torch.cuda.device(scene.device):
        entry = _SHARD_GRAPHS.get(key, lambda: ChunkGraph(
            scene, cam, li_fn, cfg, pixel_ids if box else _unpadded(pixel_ids, w * h), chunk))
        acc = entry.sums(scene, cam, base, spp_local)
        if box:
            return _gather_box(acc[0], cam, cfg, mesh)
        return filmlib.develop(_all_reduce(acc[0]), _all_reduce(acc[1]))


def _float_leaves(obj, prefix=()):
    """[(path, tensor)] of every floating-point tensor in a scene's
    dataclass tree (the JAX train step's float pytree leaves)."""
    out = []
    for f in dataclasses.fields(obj):
        x = getattr(obj, f.name)
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            out.append((prefix + (f.name,), x))
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            out.extend(_float_leaves(x, prefix + (f.name,)))
    return out


def _with_leaves(obj, leaves: dict, prefix=()):
    """obj with the tensors at the paths of `leaves` replaced."""
    changes = {}
    for f in dataclasses.fields(obj):
        path = prefix + (f.name,)
        x = getattr(obj, f.name)
        if path in leaves:
            changes[f.name] = leaves[path]
        elif dataclasses.is_dataclass(x) and not isinstance(x, type) and \
                any(p[:len(path)] == path for p in leaves):
            changes[f.name] = _with_leaves(x, leaves, path)
    return dataclasses.replace(obj, **changes)


def train_step(scene, cam, target, li_fn, cfg: RenderConfig, mesh, lr: float = 0.05):
    """One differentiable-rendering step over the mesh: the sharded
    render, the L2 loss mean((img - target)^2) over the global image, its
    gradient with respect to every float leaf of the scene, one SGD step.

    Each rank's pixels get their "sp" partial sums through a
    differentiable all-reduce; its share of the loss is scaled so that the
    all-reduces' backward sums each pixel's gradient once, and the leaf
    gradients are summed over every rank after backward. The kernels see
    detached inputs, as everywhere under autograd. Returns (new scene,
    loss), the same on every rank."""
    nsp, pixel_ids, base, spp_local, chunk = _layout(scene, cam, cfg, mesh)
    w, h = cam.width, cam.height
    paths, values = zip(*_float_leaves(scene))
    params = [v.detach().clone().requires_grad_(True) for v in values]
    s = _with_leaves(scene, dict(zip(paths, params)))
    target = target.to(pixel_ids.device)
    if cfg.filter != filmlib.FILTER_BOX:
        img, wgt = _film_sum(s, cam, li_fn, cfg, _unpadded(pixel_ids, w * h), base,
                             spp_local, chunk)
        img = filmlib.develop(_all_reduce_grad(img), _all_reduce_grad(wgt))
        loss = torch.mean((img - target) ** 2) / dist.get_world_size()
    else:
        acc = _radiance_sum(s, cam, li_fn, cfg, pixel_ids, base, spp_local, chunk)
        px = _all_reduce_grad(acc, mesh.get_group("sp")) / float(cfg.spp)
        inside = pixel_ids < w * h
        ref = target.reshape(-1, 3)[pixel_ids.clamp_max(w * h - 1)]
        loss = torch.sum(torch.where(inside[:, None], (px - ref) ** 2, 0.0)) \
            / (w * h * 3 * nsp)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    new = {}
    for path, p, g in zip(paths, params, grads):
        g = torch.zeros_like(p) if g is None else g
        new[path] = (p - lr * _all_reduce(g)).detach()
    return _with_leaves(scene, new), _all_reduce(loss.detach())
