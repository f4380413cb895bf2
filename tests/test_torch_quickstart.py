"""``examples/quickstart_torch.py`` on the CPU: the reference
quickstart's WordCount job on the port's Job API (MR-1S, held there to
MR-2S), its records held here to a ``Counter`` of the corpus."""
import importlib.util
from collections import Counter
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.data.corpus import synth_corpus  # noqa: E402
from torch_parity import REPO  # noqa: E402


def _quickstart():
    path = Path(REPO) / "examples" / "quickstart_torch.py"
    spec = importlib.util.spec_from_file_location("quickstart_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_records_equal_the_corpus_counts(capsys):
    qs = _quickstart()
    records = qs.main(qs.N_TOKENS, "cpu")
    tokens = synth_corpus(qs.N_TOKENS, vocab=qs.VOCAB, seed=0)
    assert records == dict(Counter(tokens.tolist()))
    assert "MR-1S == MR-2S result: OK" in capsys.readouterr().out
