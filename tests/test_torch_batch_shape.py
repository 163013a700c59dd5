"""What moves the backbone's fp32 gradients with a batch's shape (ROADMAP
Queue C, C1), pinned on the CPU at the tiny config with chip_smoke.py's
own study tools.

On the card, phase 6's first pair alone and in a batch of itself twice
(the same loss) gave first-step gradients 2.2e-3 apart on the level-0/1
blocks' weights, each as far from a float64 step of the same pair: the
batch's shape changed the last bits of a few leaky ReLU inputs near 0,
whose slope (1 or 0.1) then flipped, and the whole spread went with
those flips.  Here: the fp32 step alone and twice lie equally far from the
float64 step, and one leaky ReLU slope flipped at the input nearest 0
(the forward moved by less than its rounding) moves the first blocks'
weight gradients far more than the batch's shape does.
"""
import torch

import chip_smoke
from regtr_tpu_torch.config import tiny_config
from regtr_tpu_torch.models import create_model
from tests.test_torch_distributed import two_pairs

SEED = 7
# fp32 against float64 at the tiny config: each of (i) and (ii) as far,
# within a factor 2 (measured ratios 0.98-1.02 on the leaves at least 5x
# the median leaf's distance, all the backbone's)
APART = 2.0


def dist(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def setup():
    cfg = tiny_config(remat=False)
    model = create_model(cfg, 96, "cpu", seed=SEED)
    batch = two_pairs()
    pair = {k: v[:1] if k == "pose" else v[:2] for k, v in batch.items()}
    with torch.no_grad():
        levels = model.preprocess(pair["points"], pair["mask"])
    doubled = (chip_smoke.levels_as(levels, times=2),
               torch.cat([pair["pose"]] * 2),
               torch.cat([pair["overlap0"]] * 2))
    return model, pair, levels, doubled


def test_alone_and_twice_as_far_from_float64():
    model, pair, levels, doubled = setup()
    names = [n for n, _ in model.named_parameters()]
    alone, _ = chip_smoke.recorded_first_step(model, levels, pair["pose"],
                                              pair["overlap0"])
    twice, _ = chip_smoke.recorded_first_step(model, *doubled)
    exact, _ = chip_smoke.fp64_first_step(model, levels, pair)
    assert all(g.dtype == torch.float64 for g in exact)
    rows = [(dist(a, c), dist(b, c), dist(a, b), n)
            for n, a, b, c in zip(names, alone, twice, exact)
            if float(c.norm()) > 1e-6 and not n.endswith("k_proj.bias")]
    median = sorted(r[0] for r in rows)[len(rows) // 2]
    far = [r for r in rows if r[0] >= 5 * median]
    assert far and all(r[3].startswith("kpf_encoder.") for r in far)
    for a, b, _, n in far:
        assert max(a, b) <= APART * min(a, b), (n, a, b)
    # fp32 rounding alone: alone and twice no farther apart than from fp64
    assert max(r[2] for r in rows) <= max(r[0] for r in rows)


def test_one_flipped_slope_outweighs_the_batch_shape():
    model, pair, levels, doubled = setup()
    names = [n for n, _ in model.named_parameters()]
    chosen = []
    with chip_smoke.discrete_choices(model, chosen):
        alone, _ = chip_smoke.recorded_first_step(
            model, levels, pair["pose"], pair["overlap0"])
    twice, _ = chip_smoke.recorded_first_step(model, *doubled)
    kinds = {k for _, k, _ in chosen}
    assert kinds == {"leaky relu", "max pool"}

    # the leaky ReLU input nearest 0 in block 1 (at level 0, a valid row),
    # its recorded slope flipped
    near = []

    def relu_inputs(x):
        near.append(x.detach())
        return torch.nn.functional.leaky_relu(x, 0.1)

    from regtr_tpu_torch.nn import blocks
    real = blocks.leaky_relu
    blocks.leaky_relu = relu_inputs
    try:
        with torch.no_grad():
            model.forward_levels(levels)
    finally:
        blocks.leaky_relu = real
    at = next(i for i, (name, kind, _) in enumerate(chosen)
              if name == "block_1_resnetb" and kind == "leaky relu")
    x = near[sum(1 for _, k, _ in chosen[:at] if k == "leaky relu")]
    valid = levels[0].mask[..., None].expand_as(x)
    flat = torch.where(valid, x.abs(), float("inf")).reshape(-1).argmin()
    assert 0 < float(x.reshape(-1)[flat].abs()) < 1e-2
    flipped = [(n, k, c.clone()) for n, k, c in chosen]
    flipped[at][2].reshape(-1)[flat] ^= True
    moved = []
    with chip_smoke.discrete_choices(model, moved, force=flipped):
        one_flip, _ = chip_smoke.recorded_first_step(
            model, levels, pair["pose"], pair["overlap0"])
    spread = max(dist(b, a) for n, a, b in zip(names, alone, twice)
                 if float(a.norm()) > 1e-6 and not n.endswith("k_proj.bias"))
    jump = max(dist(b, a) for n, a, b in zip(names, alone, one_flip)
               if n.startswith("kpf_encoder.block_0"))
    assert jump >= 100 * spread, (jump, spread)
