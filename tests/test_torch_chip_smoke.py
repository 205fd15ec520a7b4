"""chip_smoke.py's phase selection (``--only``), on the CPU: the script's
phases run only on the card."""

import pytest
import torch

import chip_smoke

torch.set_num_threads(2)


def test_no_arguments_run_every_phase():
    assert chip_smoke.select_phases([]) == chip_smoke.PHASES


@pytest.mark.parametrize(
    "only, phases",
    [
        ("kernels", ("kernels",)),
        ("sw,kernels", ("kernels", "sw")),
        (" search , card-vs-cpu ", ("card-vs-cpu", "search")),
        ("forward", ("kernels", "forward")),
        ("end-to-end", ("kernels", "sw", "annotate", "end-to-end")),
        ("train", ("train",)),
        ("train,mesh", ("annotate", "mesh", "train")),
    ],
)
def test_only_selects_the_named_phases_and_what_they_read(only, phases):
    assert chip_smoke.select_phases(["--only", only]) == phases


@pytest.mark.parametrize("only", ["kernel", "kernels,bogus", ",", ""])
def test_only_raises_on_an_unknown_phase(only):
    with pytest.raises(ValueError, match="--only takes phases"):
        chip_smoke.select_phases(["--only", only])


def test_without_a_card_main_fails_before_any_phase(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main(["--only", "kernels"]) == 1
    assert capsys.readouterr().out == ""
