"""regtr_tpu_torch: the PyTorch + CUDA port of regtr_tpu (the inference
forward, the training step and the 3DMatch / 3DLoMatch test protocol).

Imports torch, numpy and scipy, never jax, flax, optax or yaml, and nothing
of regtr_tpu: the host-side code it needs (kernel points, se3_np, the
dataset, the loader, collate, overlap labels, the Predator scorer) is its
own copy.

Public convenience surface:
    register(src_xyz, tgt_xyz, params, cfg, device="cuda") -> dict with pose
"""
from __future__ import annotations

__version__ = "0.1.0"


def register(src_xyz, tgt_xyz, params=None, cfg=None, bucket=None,
             device="cuda"):
    """Register one pair of raw point clouds (mirrors regtr_tpu.register).

    Args:
        src_xyz / tgt_xyz: (N, 3) arrays (any count; padded to a bucket).
        params: the model's state_dict (e.g. from
            regtr_tpu_torch.convert.state_dict_from_jax); random parameters
            (seed 0) if None, useful only for pipeline checks.
        cfg: flat config dict; defaults to the 3DMatch config for big
            clouds and the ModelNet config for small ones.
        bucket: override the padded capacity.
        device: where the model runs.  "cuda" by default; raises if CUDA is
            absent instead of falling back to the CPU.

    Returns:
        dict of numpy arrays: 'pose' (3, 4) src->tgt, 'src_overlap' /
        'tgt_overlap', 'src_kp' / 'tgt_kp', 'src_kp_warped' /
        'tgt_kp_warped', as regtr_tpu.register returns them.
    """
    import numpy as np
    import torch

    from .config import modelnet_config, threedmatch_config
    from .data.collate import pick_bucket
    from .models import create_model

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("register(device='cuda'): CUDA is not available")
    src_xyz = np.asarray(src_xyz, np.float32)
    tgt_xyz = np.asarray(tgt_xyz, np.float32)
    n_max = max(len(src_xyz), len(tgt_xyz))
    if cfg is None:
        cfg = threedmatch_config() if n_max > 4096 else modelnet_config()
    n0 = bucket or pick_bucket(n_max, cfg["buckets"])
    model = create_model(cfg, n0, device)
    if params is not None:
        model.load_state_dict(params)

    def pad(c):
        out = np.zeros((n0, 3), np.float32)
        out[: len(c)] = c[:n0]
        m = np.zeros(n0, bool)
        m[: min(len(c), n0)] = True
        return out, m

    ps, ms = pad(src_xyz)
    pt, mt = pad(tgt_xyz)
    with torch.inference_mode():
        out = model(torch.from_numpy(np.stack([ps, pt])).to(device),
                    torch.from_numpy(np.stack([ms, mt])).to(device))
        kp_mask = out["kp_mask"].cpu().numpy()
        ov = torch.sigmoid(out["overlap_logits"][-1]).cpu().numpy()
        corr = out["corr"][-1].cpu().numpy()
        kp = out["kp"].cpu().numpy()
        pose = out["pose"][-1, 0].cpu().numpy()
    return {
        "pose": pose,
        "src_kp": kp[0][kp_mask[0]],
        "tgt_kp": kp[1][kp_mask[1]],
        "src_kp_warped": corr[0][kp_mask[0]],
        "tgt_kp_warped": corr[1][kp_mask[1]],
        "src_overlap": ov[0][kp_mask[0]],
        "tgt_overlap": ov[1][kp_mask[1]],
    }
