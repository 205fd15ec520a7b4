"""Where K5's time goes: the bf16 ``embed_conv`` kernel beside copies of
itself with one part taken out, timed on the card.

    python -m genomad_torch.tools.ablate_embed_conv [B] [L]

Builds ``genomad_torch/csrc/embed_conv.cu`` and, from the same source with
lines edited, kernels that skip the shared-memory table loads (each tap's
row comes from registers: the sums, the epilogue and the stores alone), the
output stores (the loads and the arithmetic alone), everything but the
stores (the staging of each unit's tokens and the store stream), or
everything after each block's copy of its table slice. Their
outputs are wrong by design; only their times mean something. Each runs at
B x L x 128 (default 128 x 6,016, the nn path's shape) on tokens of random
DNA, in turns with the others and with three yardsticks:
``F.embedding_bag`` over the same table rows, and a ``zero_`` and a
``fill_`` with 1 of the output, which write the bytes K5 must write at the
rate the card's memory reaches.
Prints milliseconds per launch (min and median of the turns), and the median
SM clock and board power nvidia-smi reads while each runs alone for a
second, as one JSON line, beside the card's name and power limit. A
measurement: it needs a card and raises without one.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

import torch

from genomad_torch.ops import _build, conv
from genomad_torch.tools.ablate_causal_conv import _clocks, _ms, build_variants

# text in embed_conv.cu -> what each ablation puts in its place
_LOADS = (("add_row(acc, *reinterpret_cast<const uint4*>(table + k * tap_bytes + offs[p + k]), k == 0);",
           "add_row(acc, make_uint4(offs[p + k], k, lane, p), k == 0);"),)
_STORES = (("if (t + p < L) *reinterpret_cast", "if (t + p < L && v.x == 1u) *reinterpret_cast"),)
_SUMS = (("const uint4 v = epilogue(acc);", "const uint4 v = make_uint4(offs[p], p, q, lane);"),)
# every block copies its table slice, then stops
_TABLE = (("__syncthreads();  // the table is in place", "__syncthreads();  // the table is in place\n    return;"),)
ABLATIONS = {
    "kernel": (),
    "no table loads": _LOADS,
    "no stores": _STORES,
    "staging and stores only": _LOADS + _SUMS,
    "table copy only": _TABLE,
}


def ablated_sources(source: str) -> dict[str, str]:
    """Each ablation's source; raises if an edited line is not in
    ``source`` exactly once (the kernel changed under the tool)."""
    out = {}
    for name, edits in ABLATIONS.items():
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise ValueError(f"{name}: expected one {old!r} in embed_conv.cu")
            text = text.replace(old, new)
        out[name] = text
    return out


def measure(sources: dict[str, str], B: int = 128, L: int = 6016, turns: int = 3) -> dict:
    """Builds each source and times its kernel beside the others and the
    yardsticks, as the module's docstring says."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this tool times kernels on the card")
    C, V = _build.TC_CHANNELS, 257
    libs = build_variants("embed_conv", sources)
    gen = torch.Generator(device="cuda").manual_seed(0)
    bases = torch.randint(0, 4, (B, L + 3), generator=gen, device="cuda", dtype=torch.uint8)
    tokens = conv.tokens_from_bases(bases).contiguous()
    w = (torch.randn((6, V, C), generator=gen, device="cuda") * 0.2).bfloat16()
    bias = (torch.randn(C, generator=gen, device="cuda") * 0.2).bfloat16()
    out = torch.empty((B, L, C), dtype=torch.bfloat16, device="cuda")
    stream = _build.stream_ptr(tokens.device)
    slope = conv._slope(torch.bfloat16)

    def launch(lib):
        _build.check(lib.embed_conv_launch(tokens.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
                                           B, L, V, C, 1, slope, 1, stream), "embed_conv")

    # embedding_bag: each position's six rows of one (6 V + 1, C) table, the
    # last row zero for the causal padding
    table = torch.cat([w.reshape(6 * V, C), w.new_zeros(1, C)])
    padded = torch.nn.functional.pad(tokens.long(), (5, 0), value=-1)
    bag = torch.stack([padded[:, k : k + L] for k in range(6)], dim=-1)
    bag = torch.where(bag >= 0, bag + V * torch.arange(6, device="cuda"), torch.full_like(bag, 6 * V)).reshape(-1, 6)
    runs = {name: (lambda lib=lib: launch(lib)) for name, lib in libs.items()}
    runs["F.embedding_bag"] = lambda: torch.nn.functional.embedding_bag(bag, table, mode="sum")
    runs["zero_ of the output"] = out.zero_
    runs["fill_ of the output with 1 (store floor)"] = lambda: out.fill_(1.0)
    times = {name: [] for name in runs}
    for _ in range(turns):  # in turns, forward and back, so drift hits every run alike
        for name in list(runs) + list(runs)[::-1]:
            times[name].append(_ms(runs[name]))
    clocks = {name: _clocks(fn) for name, fn in runs.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    result = {
        "card": smi, "B": B, "L": L, "C": C,
        "ms": {name: {"min": min(t), "median": statistics.median(t), **clocks[name]} for name, t in times.items()},
    }
    print(json.dumps(result))
    return result


def main(B: int = 128, L: int = 6016) -> dict:
    return measure(ablated_sources((_build.CSRC / "embed_conv.cu").read_text()), B, L)


if __name__ == "__main__":
    main(*map(int, sys.argv[1:3]))
