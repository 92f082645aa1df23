"""Pixel batches sharded over processes, and the differentiable train step
(port of goblin_tpu/parallel/mesh.py).

goblin_tpu shards a batch of pixel ids over a 1-D "rays" mesh of devices
and lets its partitioner insert the cross-device sums. The port runs one
process a device (parallel/multihost.py joins them into a process group):
a Mesh is this process's rank in that group and its device, each rank
takes its contiguous share of every batch, and the sums are
torch.distributed collectives on the group. With no group initialised the
world is this one process and no collective runs. Every rank holds the
whole scene on its device and the whole film:

- render_sharded: each chunk's samples are splatted by their rank into a
  film of zeros, which is summed over the ranks and added to every rank's
  film (the chunk's own contribution, never the running total);
- render_sharded_dense: each rank computes its slices of a pass's L, one
  all-gather gives every rank the whole pass, and the dense splat runs on
  every rank;
- make_sharded_train_step: the loss is the mean over the whole batch; each
  rank's loss and gradients are weighted by its share and summed.

Samples go in row-major order (goblin_tpu's screen-tile order is a TPU
artifact): only which rank renders which pixel depends on it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .. import telemetry
from ..camera import film as film_mod
from ..integrators import common


@dataclass(frozen=True)
class Mesh:
    """One rank of the 1-D rays mesh: its process group (None for one
    process), the world size, this rank and its device."""

    group: object
    world: int
    rank: int
    device: torch.device

    def share(self, n: int) -> slice:
        """This rank's contiguous share of n items (n a multiple of world
        where the caller pads; otherwise the first n % world ranks take one
        more)."""
        q, r = divmod(n, self.world)
        lo = self.rank * q + min(self.rank, r)
        return slice(lo, lo + q + (self.rank < r))

    def all_reduce(self, t):
        """Sum t over the ranks, in place."""
        if self.world > 1:
            import torch.distributed as dist

            dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, t):
        """Every rank's t stacked along a new first axis (world, ...)."""
        if self.world == 1:
            return t[None]
        import torch.distributed as dist

        out = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(out, t.contiguous(), group=self.group)
        return torch.stack(out)


def make_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """The mesh of the initialised process group (multihost.init_from_env),
    else of this process alone. device: "cuda" (this rank's current card)
    or "cpu". n_devices, when given, must be the world size: a process
    drives one device."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        group, world, rank = dist.group.WORLD, dist.get_world_size(), \
            dist.get_rank()
    else:
        group, world, rank = None, 1, 0
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh: {n_devices} devices asked for, the "
                         f"process group has {world} (one device a process)")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(group, world, rank, dev)


def _to(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, dict):
        return {k: _to(v, dev) for k, v in x.items()}
    return x


def replicate_scene(scene, mesh: Mesh):
    """The scene's tables on this rank's device (every rank loads the same
    scene, so every rank holds the same tables)."""
    return _to(scene, mesh.device)


def make_sharded_render_step(scene, meta, li_fn, mesh: Mesh):
    """-> (step, scene on the rank's device). step(color, weight, pixel_ids,
    valid, s_idx) renders this rank's share of a chunk of pixel ids (a
    multiple of the world size) and adds the chunk's samples, summed over
    the ranks, into color and weight, in place. Lanes with valid false
    carry NaN radiance, which the splat drops. The stratification grid is
    the declared spp's, as goblin_tpu's step takes it."""
    spec = meta.camera.film
    seed = int(meta.settings.get("seed", 0))
    n_grid = common.spp_grid(int(meta.settings.get("sample_per_pixel", 1)))
    scene_sh = replicate_scene(scene, mesh)

    def step(color, weight, pixel_ids, valid, s_idx):
        mine = mesh.share(pixel_ids.numel())
        pix, ok = pixel_ids[mine], valid[mine]
        x, y = common.pixel_samples(seed, pix, spec.x_res, s_idx, n_grid)
        ray = common.camera_rays(meta.camera, seed, pix, s_idx, n_grid)
        L = li_fn(scene_sh, meta, ray, pix, s_idx, seed)
        L = torch.where(ok[:, None], L, math.nan)
        d_color, d_weight = film_mod.splat(
            spec, *film_mod.new_film(spec, mesh.device), x, y, L)
        flat = mesh.all_reduce(torch.cat([d_color.reshape(-1),
                                          d_weight.reshape(-1)]))
        color += flat[:d_color.numel()].reshape(color.shape)
        weight += flat[d_color.numel():].reshape(weight.shape)
        return color, weight

    return step, scene_sh


def sharded_chunk_size(world: int, chunk_size: int) -> int:
    """render_sharded's chunk: chunk_size rounded down to a multiple of
    world, at least world."""
    return max(world, (chunk_size // world) * world)


def render_sharded(scene, meta, li_fn, mesh: Mesh, spp=None,
                   chunk_size=1 << 15):
    """The whole frame through make_sharded_render_step: chunks of
    sharded_chunk_size pixel ids, the last padded with its last id, marked
    invalid -> (H, W, 3) image, the same on every rank."""
    spec = meta.camera.film
    if spp is None:
        spp = int(meta.settings.get("sample_per_pixel", 1))
    n_spp = common.spp_grid(spp) ** 2
    step, _ = make_sharded_render_step(scene, meta, li_fn, mesh)
    chunk_size = sharded_chunk_size(mesh.world, chunk_size)
    with torch.inference_mode():
        ids = common.crop_pixel_ids(spec, mesh.device)
        n_pix = ids.numel()
        n_chunks = -(-n_pix // chunk_size)
        pad = n_chunks * chunk_size - n_pix
        ids = torch.cat([ids, ids[-1:].expand(pad)])
        valid = torch.arange(ids.numel(), device=mesh.device) < n_pix
        color, weight = film_mod.new_film(spec, mesh.device)
        for s in range(n_spp):
            for c in range(n_chunks):
                sl = slice(c * chunk_size, (c + 1) * chunk_size)
                color, weight = step(color, weight, ids[sl], valid[sl], s)
        return film_mod.to_image(color, weight)


def dense_chunk_size(n_pix: int, world: int, chunk_size: int) -> int:
    """make_sharded_render_pass's chunk: a multiple of world * 1024, no
    larger than the frame but for that rounding."""
    unit = world * 1024
    return max(unit, (min(chunk_size, n_pix) // unit) * unit)


def make_sharded_render_pass(scene, meta, li_fn, mesh: Mesh, spp, seed,
                             chunk_size=1 << 16):
    """Sharded mirror of common.make_render_pass -> (render_pass, n_spp):
    render_pass(color, weight, s_idx) renders this rank's share of every
    chunk (dense_chunk_size), all-gathers the pass's radiance once, and
    splats it densely into color and weight on every rank, in place."""
    spec = meta.camera.film
    n_grid = common.spp_grid(spp)
    scene_sh = replicate_scene(scene, mesh)
    ids_rm = common.crop_pixel_ids(spec, mesh.device)
    n_pix = ids_rm.numel()
    chunk_size = dense_chunk_size(n_pix, mesh.world, chunk_size)
    n_chunks = -(-n_pix // chunk_size)
    pad = n_chunks * chunk_size - n_pix
    ids = torch.cat([ids_rm, ids_rm[-1:].expand(pad)]).reshape(n_chunks, -1)
    mine = mesh.share(chunk_size)

    def render_pass(color, weight, s_idx: int):
        telemetry.count("render.samples", n_pix)
        with telemetry.once("setup.first_pass"), telemetry.span("render.pass"):
            L_mine = torch.stack([
                li_fn(scene_sh, meta,
                      common.camera_rays(meta.camera, seed, pix, s_idx,
                                         n_grid),
                      pix, s_idx, seed)
                for pix in ids[:, mine]])  # (n_chunks, share, 3)
            # (world, n_chunks, share, 3) -> chunk-major, then each chunk's
            # ranks in order: the pass's L in pixel order
            L = mesh.all_gather(L_mine).transpose(0, 1).reshape(-1, 3)
            return common.splat_pass(spec, color, weight, seed, ids_rm, s_idx,
                                     n_grid, L[:n_pix])

    return render_pass, n_grid * n_grid


def render_sharded_dense(scene, meta, li_fn, mesh: Mesh, spp=None,
                         chunk_size=1 << 16):
    """The whole frame through make_sharded_render_pass -> (H, W, 3) image,
    the same on every rank."""
    spec = meta.camera.film
    if spp is None:
        spp = int(meta.settings.get("sample_per_pixel", 1))
    with torch.inference_mode():
        render_pass, n_spp = make_sharded_render_pass(
            scene, meta, li_fn, mesh, spp,
            int(meta.settings.get("seed", 0)), chunk_size)
        color, weight = film_mod.new_film(spec, mesh.device)
        for s in range(n_spp):
            color, weight = render_pass(color, weight, s)
        return film_mod.to_image(color, weight)


def make_train_step(scene, meta, li_fn, boundary_grad_fn=None):
    """Build train_step(params, pixel_ids, s_idx) -> (loss, (g_light,
    g_atlas)): the mean of li over one sample of each pixel id (the camera
    as a pinhole, goblin_tpu's train step's rays), and its gradients with
    respect to params = (light_color (L, 3), tex_atlas), the light colours
    and the colour-texture atlas that replace the scene's, on the scene's
    device. The seed is meta.settings' "seed". A caller that splits a frame
    into chunks of pixel_ids weights each chunk's loss and gradients by its
    share.

    boundary_grad_fn (optional): (params, pixel_ids, s_idx) -> (g_light,
    g_atlas) added to the gradients: the visibility term AD cannot see,
    for example integrators.edge_grad.mesh_boundary_grad wrapped to these
    parameters."""
    spec = meta.camera.film
    seed = int(meta.settings.get("seed", 0))
    dev = scene["tri_rows"].device

    def train_step(params, pixel_ids, s_idx):
        light_color, tex_atlas = (
            torch.as_tensor(x, dtype=torch.float32, device=dev)
            .detach().requires_grad_() for x in params)
        sc = dict(scene, tex_atlas=tex_atlas)
        sc["lights"] = dict(scene["lights"], color=light_color)
        pixel_ids = torch.as_tensor(pixel_ids, dtype=torch.int32, device=dev)
        x, y = common.pixel_samples(seed, pixel_ids, spec.x_res, s_idx, 1)
        ray = meta.camera.generate_ray(x, y)
        loss = li_fn(sc, meta, ray, pixel_ids, s_idx, seed).mean()
        grads = torch.autograd.grad(loss, (light_color, tex_atlas),
                                    allow_unused=True)
        grads = tuple(torch.zeros_like(p) if g is None else g
                      for g, p in zip(grads, (light_color, tex_atlas)))
        if boundary_grad_fn is not None:
            extra = boundary_grad_fn(params, pixel_ids, s_idx)
            grads = tuple(g + e for g, e in zip(grads, extra))
        return loss.detach(), grads

    return train_step


def make_sharded_train_step(scene, meta, li_fn, mesh: Mesh,
                            boundary_grad_fn=None):
    """-> (train_step, scene on the rank's device). train_step(params,
    pixel_ids, s_idx) is make_train_step's over the whole batch pixel_ids
    (the same on every rank): each rank takes its share, weights its loss
    and gradients by share / batch, and one all-reduce sums the loss and
    both gradients over the ranks. boundary_grad_fn is called once, with
    the whole batch, and added after the sum. At world 1 it is
    make_train_step's step."""
    scene_sh = replicate_scene(scene, mesh)
    local = make_train_step(scene_sh, meta, li_fn)

    def train_step(params, pixel_ids, s_idx):
        pixel_ids = torch.as_tensor(pixel_ids, dtype=torch.int32,
                                    device=mesh.device)
        n = pixel_ids.numel()
        if n < mesh.world:
            raise ValueError(f"train step: {n} pixel ids for {mesh.world} "
                             "ranks")
        mine = pixel_ids[mesh.share(n)]
        loss, grads = local(params, mine, s_idx)
        if mesh.world > 1:
            w = mine.numel() / n
            flat = mesh.all_reduce(torch.cat(
                [(loss * w).reshape(1)] + [(g * w).reshape(-1)
                                           for g in grads]))
            loss = flat[0]
            grads = tuple(part.reshape(g.shape) for part, g in zip(
                flat[1:].split([g.numel() for g in grads]), grads))
        if boundary_grad_fn is not None:
            extra = boundary_grad_fn(params, pixel_ids, s_idx)
            grads = tuple(g + e for g, e in zip(grads, extra))
        return loss, grads

    return train_step, scene_sh
