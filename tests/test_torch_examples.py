"""The five examples ported as ``examples/*_torch.py`` on the CPU, each
held to the reference on the same inputs.

* ``skewed_wordcount``, ``streaming_wordcount`` and ``wordcount_puma``:
  the reference's own examples run on 8 XLA devices
  (``conftest.run_devices``) at the same token count, their ``N`` and
  corpora cut to it; every line the port prints equals the reference's
  where it holds no time (owner imbalance, split keys, record counts,
  the overflow count, tasks, unique words, the Vocab line), and the
  records equal the reference's ``wordcount_oracle`` of the same
  tokens.
* ``serve_lm``: ``repro.launch.serve`` and the port's example at the
  same flags, at the SMOKE config in fp32 with the reference's
  ``init_model`` weights carried across (``params_from_numpy``): the
  same served first rows.
* ``train_lm``: ``repro.launch.train`` on 4 XLA devices and the port's
  example at the example's flags (llama4's SMOKE config in fp32 on the
  2 x 2 mesh, the reference's initial weights carried across): step 0's
  loss within 1e-5 relative, the later steps' within 1e-3 (AdamW's eps
  of 1e-8 moves a gradient element of ~1e-7 by lr either way, so the
  packages' steps part in the last bits).

The reference runs start together in threads (two subprocesses and the
in-process serve), so the file's wall is about its slowest one.
"""
import contextlib
import dataclasses
import importlib.util
import io
import json
import re
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from conftest import run_devices  # noqa: E402
from torch_parity import REPO  # noqa: E402

CPU = "cpu"
N_WC = 2**16                  # the WordCount examples' tokens
TRAIN_STEPS = 3
SERVE_FLAGS = dict(requests=8, new_tokens=4)
WORDCOUNT = ("skewed_wordcount", "streaming_wordcount", "wordcount_puma")
EXAMPLES = ("serve_lm", "train_lm", *WORDCOUNT)


def _load(name):
    path = Path(REPO) / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the reference's WordCount examples at N_WC tokens on 8 devices: their
# printed lines, and the reference oracle's records of each corpus
_WC_REF = """
import contextlib, importlib.util, io, json, os, tempfile, types
N = {n}
def load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join({repo!r}, "examples", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
def run(mod):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main()
    return buf.getvalue()
from repro.core.usecases import wordcount_oracle
from repro.data.corpus import synth_corpus
from repro.data.source import ZipfSource, read_all
out = {{}}
sk = load("skewed_wordcount")
sk.N = N
out["skewed_wordcount"] = run(sk)
zipf = read_all(ZipfSource(N, vocab=65_536, a=1.8, seed=0))
st = load("streaming_wordcount")
part = 2 * N // 5
st.synth_corpus = lambda n, vocab, seed: synth_corpus(part, vocab, seed)
st.ZipfSource = lambda n, vocab, seed: ZipfSource(N - 2 * part, vocab=vocab,
                                                  seed=seed)
with tempfile.TemporaryDirectory() as d:
    st.tempfile = types.SimpleNamespace(mkdtemp=lambda: d)
    out["streaming_wordcount"] = run(st)
stream = [synth_corpus(part, 65_536, 0), synth_corpus(part, 65_536, 1),
          read_all(ZipfSource(N - 2 * part, vocab=65_536, seed=9))]
pu = load("wordcount_puma")
pu.synth_corpus = lambda n, vocab, seed: synth_corpus(N, vocab, seed)
out["wordcount_puma"] = run(pu)
import numpy as np
records = {{"skewed_wordcount": zipf,
            "streaming_wordcount": np.concatenate(stream),
            "wordcount_puma": synth_corpus(N, 65_536, 0)}}
out["records"] = {{k: sorted(wordcount_oracle(v, 65_536).items())
                   for k, v in records.items()}}
print("REFS" + json.dumps(out))
"""

# the reference's launch.train at the example's flags on 4 devices, its
# SMOKE configs in fp32: the losses, and the initial weights (pickled)
_TRAIN_REF = """
import dataclasses, json, os, pickle
os.environ["_REPRO_DEVICES"] = "4"
import jax
import numpy as np
from repro.configs import registry
from repro.models import transformer as jtf
smoke = registry.get_smoke_config
registry.get_smoke_config = lambda a: dataclasses.replace(
    smoke(a), dtype="float32", param_dtype="float32")
real_init = jtf.init_model
def init(cfg, key):
    p = real_init(cfg, key)
    with open({params!r}, "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, p), f)
    return p
jtf.init_model = init
from repro.launch import train
losses = train.main({argv!r})
print("LOSSES" + json.dumps(losses))
"""


def _after(tag: str, out: str):
    return json.loads(next(line[len(tag):] for line in out.splitlines()
                           if line.startswith(tag)))


def _fp32_smoke(registry):
    smoke = registry.get_smoke_config
    return lambda arch: dataclasses.replace(smoke(arch), dtype="float32",
                                            param_dtype="float32")


def _serve_ref(arch):
    """``repro.launch.serve`` at the example's flags, its SMOKE config in
    fp32: its printed lines and its initial weights (numpy)."""
    from repro.configs import registry
    from repro.launch import serve
    from repro.models import transformer as jtf
    saved, real_init, smoke = {}, jtf.init_model, registry.get_smoke_config

    def init(cfg, key):
        saved["params"] = real_init(cfg, key)
        return saved["params"]
    jtf.init_model = init
    registry.get_smoke_config = _fp32_smoke(registry)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            serve.main(["--arch", arch, "--smoke", "--requests",
                        str(SERVE_FLAGS["requests"]), "--batch", "8",
                        "--prompt-len", "32", "--new-tokens",
                        str(SERVE_FLAGS["new_tokens"])])
    finally:
        jtf.init_model, registry.get_smoke_config = real_init, smoke
    return buf.getvalue(), jax.tree.map(np.asarray, saved["params"])


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """Every reference run, started together."""
    tmp = tmp_path_factory.mktemp("examples_ref")
    params = tmp / "train_params.pkl"
    argv = _load("train_lm_torch").launcher_argv(
        steps=TRAIN_STEPS, ckpt_dir=tmp / "train_ckpt")
    with ThreadPoolExecutor(2) as pool:
        wc = pool.submit(run_devices, _WC_REF.format(n=N_WC, repo=REPO), 8)
        train = pool.submit(run_devices, _TRAIN_REF.format(
            params=str(params), argv=argv), 4)
        serve = _serve_ref(_load("serve_lm_torch").ARCH)
        out = _after("REFS", wc.result())
        losses = _after("LOSSES", train.result())
    import pickle
    with open(params, "rb") as f:
        train_params = pickle.load(f)
    return dict(wc=out, serve=serve, train=(losses, train_params))


def _lines(text: str, drop=()):
    """The non-empty lines of ``text`` without those matching ``drop``."""
    return [line for line in text.splitlines()
            if line.strip() and not any(re.search(d, line) for d in drop)]


def _check_wordcount(name, refs, capsys):
    ex = _load(f"{name}_torch")
    got = ex.main(N_WC, CPU)
    out = capsys.readouterr().out
    want = refs["wc"][name]
    records = dict(map(tuple, refs["wc"]["records"][name]))
    if name == "skewed_wordcount":
        assert _lines(out) == _lines(want)
        for part in ("hash", "sampled", "sampled+split"):
            assert got[part]["records"] == records
        assert got["sampled+split"]["split_keys"] > 0
        assert got["overflow"] > 0
    elif name == "streaming_wordcount":
        # the tasks line holds the wall and the feed's prefetch counts
        assert _lines(out, (r" tasks in ",)) == \
            _lines(want, (r" tasks in ",))
        assert [x.split(" in ")[0] for x in _lines(out, ("streaming", "=="))] \
            == [x.split(" in ")[0] for x in _lines(want, ("streaming", "=="))]
        assert got == records
    else:
        # the walls differ; the imbalance, the records and the Vocab not
        walls = r"MR-2S \d"
        assert _lines(out, (walls,)) == _lines(want, (walls,))
        imb = re.compile(r"\[imbalance [\d.]+\]")
        assert imb.findall(out) == imb.findall(want) != []
        assert got["records"] == records


def _check_serve(refs, capsys, monkeypatch):
    from repro_torch.configs import registry
    from repro_torch.models import transformer as ttf
    from repro_torch.models.convert import params_from_numpy
    want, params = refs["serve"]
    monkeypatch.setattr(registry, "get_smoke_config", _fp32_smoke(registry))
    monkeypatch.setattr(ttf, "init_model", lambda cfg, seed, device=None:
                        params_from_numpy(cfg, params, device))
    ex = _load("serve_lm_torch")
    ex.main(ex.ARCH, SERVE_FLAGS["requests"], SERVE_FLAGS["new_tokens"], CPU)
    out = capsys.readouterr().out
    rows = re.compile(r"batch \d+-\d+: first row \[[\d, ]+\]")
    assert rows.findall(out) == rows.findall(want) != []


def _check_train(refs, tmp_path, monkeypatch):
    from repro_torch.configs import registry
    from repro_torch.models import transformer as ttf
    from repro_torch.models.convert import params_from_numpy
    want, params = refs["train"]
    monkeypatch.setattr(registry, "get_smoke_config", _fp32_smoke(registry))
    monkeypatch.setattr(ttf, "init_model", lambda cfg, seed, device=None:
                        params_from_numpy(cfg, params, device))
    got = _load("train_lm_torch").main(steps=TRAIN_STEPS,
                                       ckpt_dir=tmp_path, device=CPU)
    assert len(got) == len(want) == TRAIN_STEPS
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert all(np.isfinite(got)) and got[-1] < got[0]


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_matches_the_reference(name, refs, capsys, monkeypatch,
                                       tmp_path):
    if name == "serve_lm":
        _check_serve(refs, capsys, monkeypatch)
    elif name == "train_lm":
        _check_train(refs, tmp_path, monkeypatch)
    else:
        _check_wordcount(name, refs, capsys)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_needs_a_card_unless_asked_for_the_cpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ex = _load(f"{name}_torch")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if name == "train_lm":
            ex.main(steps=1)
        elif name == "serve_lm":
            ex.main(requests=1, new_tokens=1)
        else:
            ex.main(1024)
