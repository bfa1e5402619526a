"""The card-side check's phase registry (chip_smoke/registry.py), read on
the CPU: phases 1-43 once each, in the order a whole run takes them (39
right after 31, on its live dungeon), each a function whose parameters
name fixtures that are defined, each fixture a phase makes kept by that
phase and made before any phase reads it; and the run itself on stub
phases: a fixture a phase makes runs that phase first, a fixture is built
once and let go after its last reader, and phase 1 and the closing line
come either way. Nothing here touches a device: the phases themselves run
only on the card (``python3 -m chip_smoke``)."""
import inspect
import json

from chip_smoke import fixtures, registry

RUN_ORDER = list(range(1, 32)) + [39] + list(range(32, 39)) + [40, 41, 42, 43]


def test_registry_lists_every_phase_once_with_defined_fixtures():
    numbers = [n for n, _ in registry.PHASES]
    assert numbers == RUN_ORDER and sorted(numbers) == list(range(1, 44))
    defined = set(fixtures.FIXTURES) | set(fixtures.MADE_BY)
    for n, fn in registry.PHASES:
        assert callable(fn) and fn.__name__ == f"phase{n}"
        assert set(fixtures.reads(fn)) <= defined, (n, fixtures.reads(fn))
    for name, fn in fixtures.FIXTURES.items():
        assert set(fixtures.reads(fn)) <= defined, (name, fixtures.reads(fn))
    assert not set(fixtures.FIXTURES) & set(fixtures.MADE_BY)
    position = {n: i for i, n in enumerate(numbers)}
    phases = dict(registry.PHASES)
    for name, maker in fixtures.MADE_BY.items():
        assert f"{name}=" in inspect.getsource(phases[maker]), (name, maker)
        readers = [n for n, fn in registry.PHASES if name in fixtures.needs(fixtures.reads(fn))]
        assert readers and all(position[maker] < position[n] for n in readers), (name, readers)


def test_run_hands_fixtures_on_and_lets_them_go(monkeypatch, capsys):
    ran, built = [], []

    def phase1():
        fixtures.keep(dev="card", smi="its line")
        return {"kind": "stub card", "count": 1}

    def phase2(dev):
        ran.append(2)
        fixtures.keep(made_by_2="made")

    def phase3(dev, made_by_2, scene):
        ran.append(3)
        assert (made_by_2, scene) == ("made", "scene")

    def phase4(dev, scene):
        ran.append(4)
        assert "made_by_2" not in fixtures._built  # phase 3 was its last reader

    def scene(dev):
        built.append(dev)
        return "scene"

    monkeypatch.setattr(fixtures, "FIXTURES", {"scene": scene})
    monkeypatch.setattr(fixtures, "MADE_BY", {"dev": 1, "smi": 1, "made_by_2": 2})
    monkeypatch.setattr(fixtures, "_built", {})
    monkeypatch.setattr(registry, "PHASES", ((1, phase1), (2, phase2), (3, phase3), (4, phase4)))
    monkeypatch.setattr(registry, "_results", {})
    monkeypatch.setattr(registry, "_marks", [])
    assert registry.run([4, 3]) == 0
    assert ran == [2, 3, 4] and built == ["card"] and fixtures._built == {}
    out = capsys.readouterr().out.splitlines()
    assert out[-2].startswith("chip_smoke: phases 1 2 3 4 passed in ")
    assert json.loads(out[-1]) == {"ok": True,
                                   "device": {"platform": "gpu", "kind": "stub card", "count": 1}}
