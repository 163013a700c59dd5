"""The weights a run hands to the program and to the reference alike, drawn
from --seed on the run's device in two large calls (a normal and a uniform
draw over every leaf that takes one), then made leaf by leaf by the rule
of the configuration's model family (families/<family>.py `weight_rule`),
which cells.parameter_shapes hands over with the shapes.

A rule, weight_rule(name, shape) -> (stream, finish), names the leaf's
stream, "normal", "uniform" or None, and `finish` makes the leaf from its
slice of that stream in the leaf's shape (of None: from zeros).  The
streams are cut in the order of the leaves, so a rule that takes no stream
leaves every other leaf's draw as it was.
"""
from __future__ import annotations

import math

import torch

STREAMS = ("normal", "uniform")


class Leaves(dict):
    """{name: shape} of a model's leaves (cells.parameter_shapes), with
    `rule`, its family's weight_rule."""

    def __init__(self, shapes: dict, rule):
        super().__init__(shapes)
        self.rule = rule


def draw(shapes: Leaves, seed: int, device) -> dict:
    """{name: shape} -> {name: fp32 tensor on device}."""
    rules = {n: shapes.rule(n, s) for n, s in shapes.items()}
    numel = {n: math.prod(s) for n, s in shapes.items()}
    gen = torch.Generator(device=device).manual_seed(seed)
    size = {s: sum(numel[n] for n, (t, _) in rules.items() if t == s)
            for s in STREAMS}
    drawn = {"normal": torch.randn(size["normal"], generator=gen,
                                   device=device),
             "uniform": torch.rand(size["uniform"], generator=gen,
                                   device=device)}
    at = dict.fromkeys(STREAMS, 0)
    out = {}
    for name, shape in shapes.items():
        stream, finish = rules[name]
        if stream is None:
            out[name] = finish(torch.zeros(shape, device=device))
            continue
        a = at[stream]
        out[name] = finish(drawn[stream][a:a + numel[name]].view(shape))
        at[stream] = a + numel[name]
    return out
