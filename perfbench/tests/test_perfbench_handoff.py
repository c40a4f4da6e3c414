"""The reader of ``handoff_ms.sim``: None where the program records no spans, 0
where it records spans but no write waited for its writer thread, and the waits'
sum over the writes on a registry made by hand."""

from __future__ import annotations

import pytest

from perfbench.lib import cells, spans

MS = 1_000_000  # ns
RUN = dict(window_s=1.0, steps=100)

# three writes on the simulation thread 1, the second and third waiting for the
# writer thread 2; one wait still open
COPIES = [("osg.output.copy", 100 * MS * k, 100 * MS * k + 10 * MS, None, k, 1)
          for k in range(3)]
WRITES = [("osg.output.write", 100 * MS * k + 10 * MS, 100 * MS * k + 90 * MS, None, k, 2)
          for k in range(3)]
HANDOFFS = [("osg.output.handoff", 110 * MS, 125 * MS, None, 1, 1),
            ("osg.output.handoff", 210 * MS, 250 * MS, None, 2, 1),
            ("osg.output.handoff", 310 * MS, None, None, 3, 1)]


def read(registry, monkeypatch):
    monkeypatch.setattr(spans, "registry", lambda: registry)
    return cells.metric_reader("handoff_ms.sim").read(dict(RUN), None)


def test_nothing_to_read_without_spans(monkeypatch):
    assert read(([], {}), monkeypatch) is None


def test_no_write_waited(monkeypatch):
    assert read((COPIES + WRITES, {"wait.output.copy": 12}), monkeypatch) == 0.0


def test_the_waits_over_the_writes(monkeypatch):
    got = read((COPIES + WRITES + HANDOFFS, {}), monkeypatch)
    assert got == pytest.approx((15 + 40) / 3, rel=1e-12)
