"""CPU probes behind three of the stack tests' choices (they import JAX):

    PYTHONPATH=src python tests/torch_probes.py s32
    PYTHONPATH=src python tests/torch_probes.py bf16-grads [ARCH ...]
    PYTHONPATH=src python tests/torch_probes.py router-noise

``s32``: ``tests/test_torch_moe_train.py`` run at S 32 instead of 48:
three steps in both packages for each dispatch mode and A, every
parameter element past the steps' tolerance (atol 5e-5, rtol 1e-4), and
that element's gradient in both packages at each step.

``bf16-grads``: for each arch of ``torch_stack_parity``, leaf by leaf,
how far the port's and the reference's bf16 gradients sit from the fp32
gradient of the same weights (the port's, on the reference's routing),
as fractions of the leaf's max, and their ratio, whose worst the tests
bound by 2.

``router-noise``: at llama4-maverick's smoke stack in bf16, how far each
package's router probabilities sit from the fp32 ones of the same
weights, for each MoE layer (the first follows one whole bf16 layer),
beside the packages' own gap.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

import test_torch_moe_train as moe_train
import torch_stack_parity as stack
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.train import train_step as jts
from repro_torch.models import convert
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.train import train_step as tts

LLAMA4 = "llama4-maverick-400b-a17b"
ARCHS = ("codeqwen1.5-7b", "stablelm-12b", LLAMA4)


def s32():
    S = 32
    for dispatch in ("1s", "2s"):
        jcfg, tcfg = moe_train._cfgs(dispatch)
        jp = jtf.init_model(jcfg, jax.random.key(0))
        batch = moe_train._batch(jcfg, s=S)
        jbatch = jax.tree.map(jnp.asarray, batch)
        tbatch = moe_train._torch_batch(batch)
        for A, mb in moe_train.ACCUM.items():
            jrun, trun = (dataclasses.replace(r, shape=dataclasses.replace(
                r.shape, seq_len=S)) for r in moe_train._runs(jcfg, tcfg, mb))
            jstep = jax.jit(jts.make_train_step(jcfg, jrun))
            jstate = jts.init_train_state(jcfg, jrun.train, jp)
            tstep = tts.make_train_step(tcfg, trun)
            tstate = tts.init_train_state(tcfg, trun.train,
                                          convert.params_from_numpy(
                                              tcfg, jax.tree.map(
                                                  np.asarray, jp),
                                              moe_train.CPU))
            jgrads, tgrads = [], []
            for _ in range(moe_train.STEPS):
                g = jax.grad(lambda p: jtf.loss_fn(jcfg, p, jbatch)[0])(
                    jstate.params)
                jgrads.append(moe_train._flat(jax.tree.map(np.asarray, g)))
                loss, _ = ttf.loss_fn(tcfg, tstate.params, tbatch,
                                      slot_kernel=True)
                g = torch.autograd.grad(loss, list(
                    tstate.params.parameters()))
                tgrads.append(moe_train._flat(convert.params_to_numpy(
                    tcfg, tstate.params, [x.detach() for x in g])))
                jstate, _ = jstep(jstate, jbatch)
                tstate, _ = tstep(tstate, tbatch)
            want = moe_train._flat(jax.tree.map(np.asarray, jstate.params))
            got = moe_train._flat(convert.params_to_numpy(tcfg,
                                                          tstate.params))
            bad = [(k, idx) for k in want for idx in zip(*np.nonzero(
                np.abs(got[k] - want[k]) > 5e-5 + 1e-4 * np.abs(want[k])))]
            print(f"{dispatch} A={A}: {len(bad)} elements past the "
                  f"tolerance")
            for k, idx in bad:
                print(f"  {k}{list(map(int, idx))}: |diff| "
                      f"{abs(got[k][idx] - want[k][idx]):.3g}, leaf grad "
                      f"max {np.abs(jgrads[0][k]).max():.3g}")
                for i in range(moe_train.STEPS):
                    print(f"    step {i}: grad jax {jgrads[i][k][idx]:.4g}"
                          f" port {tgrads[i][k][idx]:.4g}")


def bf16_grads(archs):
    for arch in archs:
        pair = stack.make_pair(arch, "bfloat16")
        rng = np.random.default_rng(4)
        toks = rng.integers(0, pair.tcfg.vocab_size,
                            (stack.B, stack.S + 1)).astype(np.int32)
        jbatch = {"tokens": jnp.asarray(toks[:, :-1]),
                  "labels": jnp.asarray(toks[:, 1:])}
        tbatch = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
                  "labels": torch.from_numpy(toks[:, 1:].copy())}
        calls = []
        with stack.recording(calls):
            jgrads = jax.grad(lambda p: jtf.loss_fn(pair.jcfg, p, jbatch)[0])(
                pair.jp)
        n_moe = sum(map(pair.tcfg.is_moe_layer, range(pair.tcfg.n_layers)))
        calls = calls[:n_moe]
        got = stack._loss_and_grads(pair, pair.tcfg, calls, tbatch)[2]
        cfg32 = dataclasses.replace(pair.tcfg, dtype="float32",
                                    param_dtype="float32")
        truth = stack._loss_and_grads(pair, cfg32, calls, tbatch)[2]
        want = stack._flat(jax.tree.map(np.asarray, jgrads))
        print(f"{arch}: leaf, port and reference bf16 from fp32 (of the "
              f"leaf's max), their ratio, port from reference")
        worst = 0.0
        for k in sorted(want):
            top = np.abs(truth[k]).max()
            port = np.abs(got[k] - truth[k]).max()
            ref = np.abs(want[k] - truth[k]).max()
            worst = max(worst, port / ref if ref else 0.0)
            print(f"  {k:40s} {port / top:.4f} {ref / top:.4f} "
                  f"{port / ref if ref else float('nan'):.3f} "
                  f"{np.abs(got[k] - want[k]).max() / top:.4f}")
        print(f"  worst ratio {worst:.3f}")


def router_noise():
    pair = stack.make_pair(LLAMA4, "bfloat16")
    prompts = stack.tokens(pair.tcfg, seed=3)
    probs = {}

    def record(tag, mod):
        real = mod._route

        def route(cfg, w, x):
            out = real(cfg, w, x)
            if mod is jmoe:
                jax.debug.callback(lambda p: probs.setdefault(tag, []).append(
                    np.asarray(p)), out[2], ordered=True)
            else:
                probs.setdefault(tag, []).append(out[2].float().numpy())
            return out
        return route

    cfg32 = dataclasses.replace(pair.tcfg, dtype="float32",
                                param_dtype="float32")
    m32 = convert.params_from_numpy(cfg32, jax.tree.map(
        lambda a: np.asarray(a, np.float32), pair.jp), stack.CPU)
    toks = torch.from_numpy(prompts)
    for tag, mod, run in (
            ("port bf16", tmoe, lambda: ttf.forward(pair.tcfg, pair.tp,
                                                    {"tokens": toks})),
            ("port fp32", tmoe, lambda: ttf.forward(cfg32, m32,
                                                    {"tokens": toks})),
            ("jax bf16", jmoe, lambda: jtf.forward(
                pair.jcfg, pair.jp, {"tokens": jnp.asarray(prompts)}))):
        real = mod._route
        mod._route = record(tag, mod)
        try:
            run()
        finally:
            mod._route = real
    for i, (a, b, c) in enumerate(zip(probs["port bf16"], probs["jax bf16"],
                                      probs["port fp32"])):
        print(f"MoE layer {i}: max |p - p_fp32| port {np.abs(a - c).max():.3g}"
              f", jax {np.abs(b - c).max():.3g}; port against jax "
              f"{np.abs(a - b).max():.3g}")


if __name__ == "__main__":
    what, rest = sys.argv[1], sys.argv[2:]
    {"s32": lambda: s32(), "bf16-grads": lambda: bf16_grads(rest or ARCHS),
     "router-noise": lambda: router_noise()}[what]()
