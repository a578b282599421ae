"""The port's launch CLIs against the JAX package's: ``launch.serve
--logprobs`` streams one chosen-token logprob per token, equal to
``model.chosen_logprob`` on the logits the engine chose it from; and each
of ``launch/serve.py``, ``launch/train.py`` and ``launch/dryrun.py`` in the
port offers every option of its JAX counterpart's parser (the port's own
``--device`` and ``--seed`` allowed on top).

Tolerance: logprobs within 1e-5 (the CLI prints them to six decimals)."""
import re
from pathlib import Path

import pytest
import torch

from repro_torch.launch import serve as serve_cli
from repro_torch.models import model

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
STREAM = re.compile(r"req (\d+) \+= \[([^\]]*)\] lp \[([^\]]*)\]")
# options of the port that the JAX parsers do not have
PORT_ONLY = {"--device", "--seed"}


def _numbers(text: str, kind):
    return [kind(x) for x in text.split(",") if x.strip()]


def test_stream_logprobs_match_chosen_logprob(capsys, monkeypatch):
    """``--smoke --device cpu --stream --logprobs``: every streamed delta
    carries one logprob per new token, the streamed tokens are the
    engine's, and each logprob equals ``model.chosen_logprob`` on that
    token's logits row within 1e-5 (the engine keeps the rows here)."""
    engines = []

    class Capturing(serve_cli.eng_mod.Engine):
        def __init__(self, params, cfg, ecfg, **kw):
            super().__init__(params, cfg, ecfg._replace(capture_logits=True),
                             **kw)
            engines.append(self)

    monkeypatch.setattr(serve_cli.eng_mod, "Engine", Capturing)
    stats = serve_cli.main(["--arch", "smollm-360m", "--smoke", "--device",
                            "cpu", "--stream", "--logprobs", "--requests",
                            "6", "--show-stream", "6"])
    assert stats["completed"] == 6 and len(engines) == 1
    streamed = {}
    for rid, toks, lps in STREAM.findall(capsys.readouterr().out):
        toks, lps = _numbers(toks, int), _numbers(lps, float)
        assert len(lps) == len(toks) >= 1
        got = streamed.setdefault(int(rid), ([], []))
        got[0].extend(toks)
        got[1].extend(lps)
    done = {r.rid: r for r in engines[0].completed}
    assert set(streamed) == set(done)
    for rid, (toks, lps) in streamed.items():
        req = done[rid]
        assert toks == req.out_tokens
        assert len(req.out_logits) == len(toks)
        for tok, lp, row in zip(toks, lps, req.out_logits):
            want = model.chosen_logprob(torch.as_tensor(row)[None],
                                        torch.tensor([[tok]]))
            assert abs(float(want) - lp) <= 1e-5


def test_stream_without_logprobs_prints_none(capsys):
    """Without the flag the stream lines carry no logprobs."""
    serve_cli.main(["--arch", "smollm-360m", "--smoke", "--device", "cpu",
                    "--stream", "--requests", "3"])
    out = capsys.readouterr().out
    assert "+= [" in out and " lp [" not in out


def _options(path: Path) -> set:
    """Every ``--option`` a launcher's parser declares (the JAX launchers
    build their parser inside ``main``, so the source is read)."""
    src = path.read_text()
    names = set(re.findall(r"add_argument\(\s*\"(--[a-z0-9-]+)\"", src))
    assert names, path
    return names


@pytest.mark.parametrize("name", ["serve", "train", "dryrun"])
def test_port_cli_offers_every_jax_option(name):
    jax_opts = _options(ROOT / "src" / "repro" / "launch" / f"{name}.py")
    port_opts = _options(ROOT / "src" / "repro_torch" / "launch"
                         / f"{name}.py")
    assert jax_opts - port_opts == set(), f"{name}: missing"
    assert port_opts - jax_opts <= PORT_ONLY, f"{name}: extra"


def test_port_serve_parser_is_what_the_source_declares():
    """The source scan above reads what ``build_parser`` really builds."""
    parsed = {o for a in serve_cli.build_parser()._actions
              for o in a.option_strings if o.startswith("--")}
    declared = _options(ROOT / "src" / "repro_torch" / "launch" / "serve.py")
    assert declared <= parsed
    assert "--logprobs" in parsed
