"""Register one pair of clouds (the port's counterpart of the root
demo.py).

    python -m regtr_tpu_torch.demo [--example 0-4 | --src A --tgt B] \\
        [--params params.npz | --ckpt RUN_OR_CKPT_DIR] [--config conf.yaml] \\
        [--out demo_out] [--save_attn] [--device cuda]

Clouds are .ply, .pth (3DMatch fragments) or .bin (KITTI-style float32
rows of 6).  Without --config the preset follows the size: the 3DMatch
config above 4096 points, the ModelNet one below; the model is built at the
bucket the larger cloud picks.  --params loads a flat .npz, --ckpt the best
checkpoint of a run of `python -m regtr_tpu_torch.train` (or an .npz);
without either the weights are random (seed 0), which exercises the
pipeline only.  It prints the pose and the source's overlap scores and
writes before.ply and after.ply (source red, target blue) to --out; with
--save_attn also attn.npz, the 12 attention maps of the cross-encoder
(clouds, heads, N, N each at the padded capacity: ~0.5 GB apiece at the
3DMatch config's width).  --device: "cuda" (the default) raises where there
is no CUDA device; the CPU runs only when asked for.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

# (src, tgt) pairs of upstream RegTR's demo data, relative to its src/
# directory.
DEMO_EXAMPLES = [
    ("../data/indoor/test/7-scenes-redkitchen/cloud_bin_0.pth",
     "../data/indoor/test/7-scenes-redkitchen/cloud_bin_5.pth"),
    ("../data/indoor/test/sun3d-home_at-home_at_scan1_2013_jan_1/"
     "cloud_bin_38.pth",
     "../data/indoor/test/sun3d-home_at-home_at_scan1_2013_jan_1/"
     "cloud_bin_41.pth"),
    ("../data/indoor/test/sun3d-hotel_umd-maryland_hotel3/cloud_bin_8.pth",
     "../data/indoor/test/sun3d-hotel_umd-maryland_hotel3/cloud_bin_15.pth"),
    ("../data/modelnet_demo_data/modelnet_test_2_0.ply",
     "../data/modelnet_demo_data/modelnet_test_2_1.ply"),
    ("../data/modelnet_demo_data/modelnet_test_630_0.ply",
     "../data/modelnet_demo_data/modelnet_test_630_1.ply"),
]

SRC_COLOR = (255, 80, 80)
TGT_COLOR = (80, 160, 255)


def load_cloud(path):
    """(N, 3) float32 points of a .ply, .pth or .bin cloud."""
    path = str(path)
    if path.endswith(".ply"):
        from .utils.ply import read_ply_xyz

        return read_ply_xyz(path)
    if path.endswith(".pth"):
        import torch

        # the fragments are pickled numpy arrays
        return np.asarray(torch.load(path, weights_only=False), np.float32)
    if path.endswith(".bin"):
        return np.fromfile(path, np.float32).reshape(-1, 6)[:, :3].copy()
    raise ValueError(f"unsupported cloud format: {path}")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Register one pair of clouds")
    p.add_argument("--example", type=int, default=0,
                   help=f"Demo example index (0-{len(DEMO_EXAMPLES) - 1})")
    p.add_argument("--src", type=str, help="Source cloud (overrides example)")
    p.add_argument("--tgt", type=str, help="Target cloud (overrides example)")
    p.add_argument("--ckpt", type=str,
                   help="Run or checkpoint directory of the port's trainer, "
                        "or a flat .npz (random weights without it)")
    p.add_argument("--params", type=str,
                   help="Flat .npz params; alternative to --ckpt")
    p.add_argument("--config", type=str, help="Config YAML")
    p.add_argument("--out", type=str, default="demo_out",
                   help="Output dir for the PLY files")
    p.add_argument("--save_attn", action="store_true",
                   help="Also save the cross-encoder's attention maps (per "
                        "layer, self and cross) to attn.npz")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    """Returns the model's outputs and, with --save_attn, the maps (as
    tensors on the device)."""
    opt = parse_args(argv)
    import torch

    from .config import load_config, modelnet_config, threedmatch_config
    from .core import se3_np
    from .data.collate import pick_bucket
    from .models import create_model
    from .nn.transformer import record_attention
    from .train.checkpoints import (CheckpointManager, load_params_npz,
                                    resolve_ckpt_dir)
    from .train.steps import make_forward
    from .utils.ply import write_ply

    device = torch.device(opt.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: CUDA is not available")
    src = load_cloud(opt.src or DEMO_EXAMPLES[opt.example][0])
    tgt = load_cloud(opt.tgt or DEMO_EXAMPLES[opt.example][1])
    print(f"src: {src.shape}, tgt: {tgt.shape}")

    if opt.config:
        cfg = load_config(opt.config)
    elif max(len(src), len(tgt)) > 4096:
        cfg = threedmatch_config()
    else:
        cfg = modelnet_config()
    n0 = pick_bucket(max(len(src), len(tgt)), cfg["buckets"])
    model = create_model(cfg, n0, device)

    def pad(c):
        out = np.zeros((n0, 3), np.float32)
        out[: len(c)] = c[:n0]
        m = np.zeros(n0, bool)
        m[: min(len(c), n0)] = True
        return out, m

    ps, ms = pad(src)
    pt, mt = pad(tgt)
    points = torch.from_numpy(np.stack([ps, pt])).to(device)
    mask = torch.from_numpy(np.stack([ms, mt])).to(device)

    npz_path = opt.params or (
        opt.ckpt if opt.ckpt and opt.ckpt.endswith(".npz") else None)
    if npz_path:
        load_params_npz(npz_path, model)
        print(f"loaded .npz params from {npz_path}")
    elif opt.ckpt:
        step = CheckpointManager(resolve_ckpt_dir(opt.ckpt)).restore(
            model, best=True)
        print(f"loaded checkpoint step {step}")
    else:
        print("WARNING: no checkpoint given; using random weights")

    maps = None
    if opt.save_attn:
        with record_attention(model) as maps:
            out = make_forward(model)(points, mask)
    else:
        out = make_forward(model)(points, mask)
    pose = out["pose"][-1, 0].cpu().numpy()
    kp_mask = out["kp_mask"][0].cpu().numpy()
    src_overlap = torch.sigmoid(out["overlap_logits"][-1, 0]).cpu().numpy()
    src_overlap = src_overlap[kp_mask]
    print("Predicted pose (src -> tgt):")
    print(np.array2string(pose, precision=4, suppress_small=True))
    print(f"overlap scores: mean {src_overlap.mean():.3f}, "
          f"frac>0.5: {(src_overlap > 0.5).mean():.3f}")

    outdir = Path(opt.out)
    outdir.mkdir(parents=True, exist_ok=True)
    colors = np.concatenate([
        np.tile(SRC_COLOR, (len(src), 1)), np.tile(TGT_COLOR, (len(tgt), 1)),
    ]).astype(np.uint8)
    names = ["x", "y", "z", "red", "green", "blue"]
    write_ply(outdir / "before.ply", [np.concatenate([src, tgt]), colors],
              names)
    write_ply(outdir / "after.ply",
              [np.concatenate([se3_np.se3_transform(pose, src), tgt]),
               colors], names)
    print(f"wrote {outdir}/before.ply and {outdir}/after.ply")

    if maps is not None:
        # clouds 0 and 1: the source and the target
        np.savez_compressed(outdir / "attn.npz", **{
            name: m.cpu().numpy() for name, m in maps.items()})
        shapes = {k: tuple(v.shape) for k, v in list(maps.items())[:2]}
        print(f"wrote {outdir}/attn.npz: {len(maps)} attention maps, "
              f"e.g. {shapes}")
    return dict(outputs=out, maps=maps)


if __name__ == "__main__":
    main()
