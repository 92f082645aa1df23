"""The differentiable train step (port of the one-device case of
goblin_tpu/parallel/mesh.py::make_sharded_train_step).

goblin_tpu shards a step's pixel batch over a mesh of devices and lets its
partitioner all-reduce the gradients. This module is that step on one
device, the scene's: the card, unless the scene was loaded on the CPU. The
process group and the all-reduce over several cards, and the sharded
render steps, are ROADMAP Queue 1 item 15.
"""

from __future__ import annotations

import torch

from ..integrators import common


def make_train_step(scene, meta, li_fn, boundary_grad_fn=None):
    """Build train_step(params, pixel_ids, s_idx) -> (loss, (g_light,
    g_atlas)): the mean of li over one sample of each pixel id (the camera
    as a pinhole, goblin_tpu's train step's rays), and its gradients with
    respect to params = (light_color (L, 3), tex_atlas), the light colours
    and the colour-texture atlas that replace the scene's. The seed is
    meta.settings' "seed". A caller that splits a frame into chunks of
    pixel_ids weights each chunk's loss and gradients by its share.

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
