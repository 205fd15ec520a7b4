"""chip_smoke.py's phase selection (``--only``), on the CPU: the script's
phases run only on the card."""

import sys

import numpy as np
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


def test_sw_times_names_a_tree_and_needs_a_card(monkeypatch, capsys):
    """K1's turns between two trees are a tool of their own
    (``genomad_torch.tools.sw_turns OTHER``), not a mode of chip_smoke.py:
    the tool takes another revision or archive, fails without a card
    before it unpacks anything, and leaves sys.path as it was."""
    from genomad_torch.tools import sw_turns

    with pytest.raises(SystemExit):
        chip_smoke.parse_args(["--sw-times", "parent"])
    args = sw_turns.parse_args(["parent.tar"])
    assert (args.other, args.turn) == ("parent.tar", None)
    with pytest.raises(SystemExit):
        sw_turns.parse_args([])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sw_turns, "unpack", lambda *a: pytest.fail("unpacked without a card"))
    path = list(sys.path)
    assert sw_turns.main(["parent.tar"]) == 1
    assert sys.path == path
    assert capsys.readouterr().out == ""


def test_sw_turns_unpacks_an_archive_into_its_own_directory(tmp_path):
    """The other tree is unpacked where the tool says (its own temporary
    directory), never into a checkout; an archive without K1's wrapper is
    refused."""
    import tarfile

    from genomad_torch.tools import sw_turns

    def archive(name, files):
        path = tmp_path / name
        with tarfile.open(path, "w") as tar:
            for rel in files:
                src = tmp_path / "src" / name / rel
                src.parent.mkdir(parents=True, exist_ok=True)
                src.write_text("# stub\n")
                tar.add(src, arcname=rel)
        return str(path)

    good = archive("good.tar", ["genomad_torch/__init__.py", "genomad_torch/ops/sw.py", "chip_smoke.py"])
    into = tmp_path / "turn"
    into.mkdir()
    assert sw_turns.unpack(good, into) == into
    assert (into / "genomad_torch" / "ops" / "sw.py").read_text() == "# stub\n"
    bad = archive("bad.tar", ["genomad_torch/__init__.py"])
    (tmp_path / "bad").mkdir()
    with pytest.raises(ValueError, match="no genomad_torch/ops/sw.py"):
        sw_turns.unpack(bad, tmp_path / "bad")


def test_sw_bucket_pairs_takes_a_query_bound_of_its_own():
    """Queries of the 256 bucket against the 4096 profile bucket of the
    long-profile recipe: every query length in (128, 256], and the planted
    third windows of their profile's consensus."""
    from genomad_torch.ops.profiledb import ProfileDB

    db = ProfileDB.synthetic(seed=5, n_profiles=30, min_len=1025, max_len=3000, integral=True)
    all_q, all_p, idx, (q_len, p_len) = chip_smoke.sw_bucket_pairs(db, 4096, 24, np.random.default_rng(0), torch.device("cpu"), Lq_bound=256)
    assert all_q.shape == (24, 256) and all_p.shape[1] == 4096
    assert bool(((q_len > 128) & (q_len <= 256)).all())
    assert bool((p_len[idx[1].long()] > 1024).all())
    assert bool((all_q == 20).sum(1).eq(256 - q_len).all())  # code 20 past each length, nowhere before
