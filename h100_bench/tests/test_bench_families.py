"""An agent configuration's text LM is a family looked up by name: the
key's absence means `qwen3`, and an unknown name stops the run before any
weights are drawn."""

import json

import pytest

from h100_bench import families, weights
from h100_bench.tests import _tiny


@pytest.mark.parametrize("path", [_tiny.ROOT / "h100_bench" / "configs" /
                                  "qwen3-0.6b-voice-agent.json", _tiny.HERE / "tiny-agent.json"],
                         ids=lambda p: p.stem)
def test_a_configuration_without_the_key_is_qwen3(path):
    cfg = json.loads(path.read_text())
    assert "lm_family" not in cfg
    assert families.load(cfg) is families.load(dict(cfg, lm_family="qwen3"))
    assert families.load(cfg).__name__ == "h100_bench.families.qwen3"


@pytest.mark.parametrize("name", ["no_such_lm", "../run"])
def test_an_unknown_family_stops_the_run_before_weights_are_drawn(capsys, monkeypatch,
                                                                   tmp_path, name):
    from h100_bench import run as bench

    def drawn(*a, **k):
        raise AssertionError("weights drawn")

    for f in ("make_tts", "make_code2wav", "make_lm"):
        monkeypatch.setattr(weights, f, drawn)
    cfg = json.loads((_tiny.HERE / "tiny-agent.json").read_text())
    path = tmp_path / "agent.json"
    path.write_text(json.dumps(dict(cfg, lm_family=name)))
    assert bench.main(_tiny.argv("agent-turn", 51, 1.0, 0, "--config-file", str(path))) != 0
    out = capsys.readouterr()
    assert out.out == ""
    assert repr(name) in out.err and str(families.HERE) in out.err
