"""The traffic generator: a pure function of (mix, seed); every seed gets
the same lengths and documents in another order."""
import json
from pathlib import Path

import numpy as np

from benchkit.traffic import Traffic

MIXES = Path(__file__).resolve().parents[1] / "traffic"


def mix(name):
    return json.loads((MIXES / f"{name}.json").read_text())


def test_same_seed_same_traffic():
    for name in ("prefix_docs", "prefix_unique", "switch"):
        a, b = Traffic(mix(name), 2**31 + 77, 50304), Traffic(mix(name), 2**31 + 77, 50304)
        for i in (0, 1, 63, 64, 200, 5):
            ra, rb = a.request(i), b.request(i)
            assert np.array_equal(ra["tokens"], rb["tokens"]) and ra["doc"] == rb["doc"]


def test_other_seed_same_work_other_order():
    m = mix("prefix_docs")
    a, b = Traffic(m, 1, 50304), Traffic(m, 2**33 + 5, 50304)
    la = sorted(len(a.request(i)["tokens"]) for i in range(64))
    lb = sorted(len(b.request(i)["tokens"]) for i in range(64))
    assert la == lb
    assert [len(a.request(i)["tokens"]) for i in range(64)] != \
        [len(b.request(i)["tokens"]) for i in range(64)]
    docs = [a.request(i)["doc"] for i in range(64)]
    assert sorted(np.bincount(docs).tolist()) == [8] * 8


def test_lengths_and_ranges():
    m = mix("prefix_docs")
    t = Traffic(m, 9, 50304)
    lens = [len(t.request(i)["tokens"]) for i in range(128)]
    assert min(lens) >= 3072 + 64 and max(lens) <= 3072 + 256
    assert t.longest_prompt() == 3072 + 256 and t.shortest_prompt() == 3072 + 64
    r = t.request(3)
    assert np.array_equal(r["tokens"][:3072], t.docs[r["doc"]])
    u = Traffic(mix("prefix_unique"), 9, 50304)
    assert not np.array_equal(u.request(0)["tokens"][:3072], u.request(1)["tokens"][:3072])
    s = Traffic(mix("switch"), 9, 50304)
    assert all(512 <= len(s.request(i)["tokens"]) <= 2048 for i in range(64))
    assert all(0 <= int(s.request(i)["tokens"].max()) < 50304 for i in range(8))
