"""The port's training CLI (``python -m repro_torch.launch.train``) on the
CPU, then ``launch.serve --restore`` from its workdir: the served tokens
are those of the trained model served from memory, an MoE run's router
bias comes back with it, a second run resumes from the newest checkpoint,
and without ``--device cpu`` the CLI refuses to start where no card is
visible."""
import tempfile

import pytest
import torch

from repro_torch import configs, prng
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.serve import decode

torch.set_num_threads(1)


def _train(arch, workdir, steps):
    tr, state = train_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                                "--steps", str(steps), "--batch", "4",
                                "--seq", "32", "--ckpt-every", "5",
                                "--workdir", workdir])
    return tr, state


def _served_from_memory(params, cfg, bias, batch=2, prompt_len=16, steps=8):
    """What ``serve_batch`` serves, from ``params`` in memory: its prompts
    (``jax.random.randint`` under key 1), greedy."""
    key = torch.as_tensor(prng.PRNGKey(1).astype("int64"))
    prompts = {"tokens": prng.randint(key, (batch, prompt_len), 0,
                                      cfg.vocab_size).long()}
    toks, _ = decode.generate(params, cfg, prompts,
                              max_cache=prompt_len + steps + 8, steps=steps,
                              router_bias=bias)
    return toks


def test_train_then_serve_restore(capsys):
    cfg = configs.get_config("smollm-360m").smoke()
    with tempfile.TemporaryDirectory() as d:
        tr, state = _train("smollm-360m", d, 12)
        out = capsys.readouterr().out
        assert "step     0" in out and f"done; checkpoints in {d}" in out
        assert tr.history[-1]["step"] == 11
        served = serve_cli.main(["--arch", "smollm-360m", "--smoke",
                                 "--device", "cpu", "--batch", "2",
                                 "--steps", "8", "--restore", d])
        assert "restored step 12 from" in capsys.readouterr().out
        assert torch.equal(served, _served_from_memory(state.params, cfg,
                                                       None))
        # a second run with more steps resumes from step 12 (a fresh run
        # would log steps 0 and 10 too)
        tr2, state2 = _train("smollm-360m", d, 15)
        assert [h["step"] for h in tr2.history] == [14]
        assert int(state2.step) == 15


def test_moe_serve_restore_takes_the_router_bias(capsys):
    cfg = configs.get_config("granite-moe-3b-a800m").smoke()
    with tempfile.TemporaryDirectory() as d:
        _, state = _train("granite-moe-3b-a800m", d, 6)
        bias = state.router.bias
        assert bias.abs().max() > 0
        served = serve_cli.main(["--arch", "granite-moe-3b-a800m", "--smoke",
                                 "--device", "cpu", "--batch", "2",
                                 "--steps", "8", "--restore", d])
        assert torch.equal(served,
                           _served_from_memory(state.params, cfg, bias))
        stats = serve_cli.main(["--arch", "granite-moe-3b-a800m", "--smoke",
                                "--device", "cpu", "--stream",
                                "--requests", "4", "--steps", "8",
                                "--restore", d])
    assert stats["completed"] == 4


def test_train_cli_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(SystemExit):
            train_cli.main(["--arch", "smollm-360m", "--smoke",
                            "--workdir", d])
