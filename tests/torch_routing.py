"""Routing parity helpers for the MoE stack tests (they import JAX).

Routing is discrete, so where two experts' router probabilities tie to
within bf16's rounding, the two packages may pick apart, and one token's
output moves by a whole expert's. A stack-level comparison therefore
records the reference's routing of every MoE call (``recording``) and
runs the port with it (``same_routing``): every row the port routes
otherwise must be such a tie (its own probabilities of the two choices
within ``TIE``), and in fp32 none may differ.
"""
import contextlib
from unittest import mock

import jax
import numpy as np
import torch

from repro.models import moe as jmoe
from repro_torch.models import moe as tmoe

# a router probability gap that bf16 rounding may cross (1e-3 of a
# probability, against bf16's relative step of 2**-8 on the router input)
TIE = {"float32": 0.0, "bfloat16": 1e-3}


@contextlib.contextmanager
def recording(calls: list):
    """Append the expert ids of every reference ``_route`` call (under
    jit and scans, through an ordered debug callback) to ``calls``."""
    real = jmoe._route

    def route(cfg, router_w, x_flat):
        out = real(cfg, router_w, x_flat)
        jax.debug.callback(lambda ids: calls.append(np.asarray(ids)),
                           out[0], ordered=True)
        return out

    with mock.patch.object(jmoe, "_route", route):
        yield


@contextlib.contextmanager
def same_routing(calls: list, dtype: str, flips: list, tie=None):
    """Run the port's ``_route`` calls with the recorded reference ids,
    call by call: a row whose expert set differs must be a tie (each
    expert only the reference picked within ``tie``, by default
    ``TIE[dtype]``, of the port's k-th probability); its gates are the
    port's probabilities of the reference's experts, renormalised.
    ``flips`` gets each call's count of such rows (none in fp32; a few
    in bf16)."""
    tie = TIE[dtype] if tie is None else tie
    real = tmoe._route
    it = iter(calls)

    def route(cfg, router_w, x_flat):
        ids, gates, probs = real(cfg, router_w, x_flat)
        want = torch.from_numpy(next(it).copy())
        assert want.shape == ids.shape
        differ = (ids.sort(-1)[0] != want.sort(-1)[0]).any(-1)
        kth = probs.gather(1, ids.long()).amin(-1)
        gap = kth[:, None] - probs.gather(1, want.long())
        assert float(torch.where(differ[:, None], gap, 0.0).max()) \
            <= tie, \
            "a routing choice apart from the reference's is not a tie"
        flips.append(int(differ.sum()))
        g = probs.gather(1, want.long())
        return want, g / g.sum(-1, keepdim=True).clamp_min(1e-9), probs

    with mock.patch.object(tmoe, "_route", route):
        yield
    assert next(it, None) is None, "the port routed fewer calls"


@contextlib.contextmanager
def mesh_recording(calls: list, axes=("data", "model")):
    """``recording`` for the reference's MoE calls inside a ``shard_map``
    over ``axes``: each device's call appends (its index along each
    axis, its expert ids) through an unordered debug callback (an
    ordered one is refused there); ``jax.effects_barrier()`` before
    reading, then ``assemble``."""
    from jax import lax
    real = jmoe._route

    def route(cfg, router_w, x_flat):
        out = real(cfg, router_w, x_flat)
        jax.debug.callback(
            lambda ids, *at: calls.append(
                (tuple(int(a) for a in at), np.asarray(ids))),
            out[0], *(lax.axis_index(a) for a in axes))
        return out

    with mock.patch.object(jmoe, "_route", route):
        yield


def assemble(calls: list, mesh_shape) -> list:
    """The per-device calls of ``mesh_recording`` as the port makes them:
    its MoE region routes every rank's tokens in one ``_route`` call, rank
    after rank in mesh order. A device's calls arrive in its program
    order; the k-th call of each device makes the k-th routing."""
    by_rank: dict = {}
    for at, ids in calls:
        by_rank.setdefault(at, []).append(ids)
    ranks = sorted(by_rank)
    assert len(ranks) == int(np.prod(mesh_shape)), (len(ranks), mesh_shape)
    n = {len(v) for v in by_rank.values()}
    assert len(n) == 1, n
    return [np.concatenate([by_rank[r][k] for r in ranks])
            for k in range(n.pop())]
