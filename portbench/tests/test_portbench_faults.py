"""Each fault a cell can have, planted under the timed path of a CPU
rehearsal, turns ``correct`` false: the harness's look for a card is
skipped, the rest of a run is driven as it is. Training cells: a step that
returns its state unchanged, and half of the batch left out (the mean
taken over the rest). The serving cell: a token altered where it is
produced. (One card: no exchange between chips to leave out.)"""
import pytest
import torch

from _tiny import run_cpu, tiny_cell

TRAIN_CELLS = ["granite-moe-3b.train", "minicpm-2b.train"]


@pytest.fixture
def train_step_mod():
    from repro_torch.train import train_step
    return train_step


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_sound_training_run_is_correct(name):
    assert run_cpu(tiny_cell(name), seconds=1.0)["correct"] is True


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_step_returning_its_state_unchanged_is_caught(name, train_step_mod,
                                                      monkeypatch):
    real = train_step_mod.train_step

    def frozen(state, batch, cfg, tcfg, rcfg=None):
        params = list(state.params.parameters())
        with torch.no_grad():
            saved = [p.detach().clone() for p in params]
        _, metrics = real(state, batch, cfg, tcfg, rcfg)
        with torch.no_grad():
            for p, s in zip(params, saved):
                p.copy_(s)
        return state, metrics

    monkeypatch.setattr(train_step_mod, "train_step", frozen)
    out = run_cpu(tiny_cell(name), seconds=1.0)
    assert out["correct"] is False
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_half_the_batch_left_out_is_caught(name, train_step_mod,
                                           monkeypatch):
    real = train_step_mod.train_step

    def halved(state, batch, cfg, tcfg, rcfg=None):
        b = batch["tokens"].shape[0] // 2
        return real(state, {k: v[:b] for k, v in batch.items()}, cfg, tcfg,
                    rcfg)

    monkeypatch.setattr(train_step_mod, "train_step", halved)
    out = run_cpu(tiny_cell(name), seconds=1.0)
    assert out["correct"] is False


def test_token_altered_where_produced_is_caught(monkeypatch):
    """Every greedy token the engine produces is moved to the next id."""
    from repro_torch.serve import engine
    real = engine.greedy

    def altered(logits):
        tok = real(logits)
        return (tok + 1) % logits.shape[-1]

    monkeypatch.setattr(engine, "greedy", altered)
    out = run_cpu(tiny_cell("minicpm-2b.docqa", wide=True), seconds=2.0)
    assert out["correct"] is False


def test_sound_serving_run_is_correct():
    out = run_cpu(tiny_cell("minicpm-2b.docqa", wide=True), seconds=2.0)
    assert out["correct"] is True
