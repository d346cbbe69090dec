"""The port's serving launcher (``python -m repro_torch.launch.serve``)
against the reference's (``python -m repro.launch.serve``), and
``build_model`` over every configuration of the registry."""

import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import ARCHITECTURES, reduced_config
from repro_torch.launch import serve as tserve
from repro_torch.models.api import build_model

SMALL = ["--requests", "4", "--prompt-len", "8", "--max-new", "4",
         "--max-len", "32", "--reduced"]


def _jax_main(monkeypatch, arch):
    from repro.launch import serve as jserve
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", arch, *SMALL])
    jserve.main()


@pytest.mark.parametrize("arch", ["internvl2-1b", "dbrx-132b"])
def test_both_launchers_serve_reduced(monkeypatch, capsys, arch):
    """``--reduced`` (4 layers, d_model 128): both launchers complete every
    request with its 4 tokens (the vlm family serves text only)."""
    _jax_main(monkeypatch, arch)
    assert "completed 4/4 requests, 16 tokens" in capsys.readouterr().out
    srv = tserve.main(["--arch", arch, "--device", "cpu", *SMALL])
    out = capsys.readouterr().out
    assert f"serving {arch} on cpu" in out
    assert "completed 4/4 requests, 16 tokens" in out
    assert srv.model.cfg.num_layers == 4 and srv.model.cfg.d_model == 128
    assert all(len(r.tokens) == 4 for r in srv.completed.values())


def test_both_launchers_fail_on_encdec(monkeypatch):
    """Requests carry tokens only, so seamless-m4t-medium has no frames to
    prefill: both launchers raise ``KeyError: 'frames'``."""
    with pytest.raises(KeyError, match="frames"):
        _jax_main(monkeypatch, "seamless-m4t-medium")
    with pytest.raises(KeyError, match="frames"):
        tserve.main(["--arch", "seamless-m4t-medium", "--device", "cpu",
                     *SMALL])


def test_launcher_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tserve.main(["--arch", "dbrx-132b", *SMALL])


@pytest.mark.parametrize("name", sorted(ARCHITECTURES))
def test_every_config_builds(name):
    """``build_model`` builds every configuration at full size on the CPU
    (no weights are drawn), and its reduced config prefills and decodes
    there: finite logits over the padded vocabulary."""
    cfg = ARCHITECTURES[name]
    assert build_model(cfg, device="cpu").cfg is cfg
    small = reduced_config(cfg)
    model = build_model(small, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, small.vocab_size, (2, 8)).astype(np.int32))}
    if small.family == "encdec":
        batch["frames"] = torch.randn((2, 8, small.d_model),
                                      generator=torch.Generator()
                                      .manual_seed(1))
    logits, cache = model.prefill(params, batch, max_len=16)
    logits, _ = model.decode_step(params, cache, logits.argmax(-1).to(
        torch.int32)[:, None], cache["lengths"])
    assert logits.shape == (2, small.padded(1).vocab_size)
    assert torch.isfinite(logits.float()).all()
