"""chip_smoke.py's own copy of the ZIP-215 conformance corpus.

The smoke script may import neither tests/ nor cometbft_tpu, so it builds
the ZIP-215 equivalence classes itself with the port's ed25519_ref and
runs them through K1-K4 on the card. Its list must stay equal to
tests/test_zip215_conformance.py::build_corpus, vector for vector.
"""

import importlib.util
from pathlib import Path

from test_zip215_conformance import build_corpus


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_smoke_corpus_equals_the_conformance_corpus():
    ours = _chip_smoke().zip215_corpus()
    theirs = build_corpus()
    assert [v[0] for v in ours] == [v[0] for v in theirs]
    assert ours == theirs
    assert sum(v[4] for v in ours) == 25  # accepted vectors
