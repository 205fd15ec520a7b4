"""Window encoding + batched inference on the card + per-contig score merge.

Port of ``genomad_tpu/ops/nn_pipeline.py``, with the same data semantics as
the reference NN module (genomad/modules/nn_classification.py:54-100,
316-320):

  * contigs are read with strip_n, split into 6,000 bp windows
    (min 2,500 bp; a short first window is always kept);
  * windows after the first are dropped if they contain > 4,000 Ns;
  * windows are N-padded to 6,000 bp and encoded as uint8 base codes
    (tokenized on the device by the model);
  * per-window class probabilities are averaged per contig (segment mean).

Batches go to the card as uint8 codes from pinned host memory and the
results stay on the card until the last batch is done. With a mesh, the
windows split over the ``data`` cells, each on its own replica of the
model.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable

import copy

import numpy as np
import torch

from genomad_torch import sequence, trace
from genomad_torch.models import igloo
from genomad_torch.parallel import mesh as meshlib

WINDOW_LENGTH = 6_000
MIN_WINDOW_LENGTH = 2_500
MAX_WINDOW_NS = 4_000


def encode_windows(fasta_path: Path, single_window: bool = False):
    """Encode a FASTA file into (base_codes, contig_names, contig_ids).

    base_codes: uint8 (n_windows, 6000) with ACGT=0..3, N/other=4.
    contig_ids maps window -> contig index. Counts ``nn.window_bp``: the
    contigs' bases put into windows, before the N padding.
    """
    contig_names: list[str] = []
    contig_ids: list[int] = []
    base_rows: list[np.ndarray] = []
    max_windows = 1 if single_window else None
    window_bp = 0
    for contig_id, seq in enumerate(sequence.read_fasta(fasta_path, strip_n=True)):
        contig_names.append(seq.accession)
        for window_n, window in enumerate(
            sequence.seq_windows(seq, WINDOW_LENGTH, MIN_WINDOW_LENGTH, max_windows=max_windows)
        ):
            if window_n > 0 and window.count("N") > MAX_WINDOW_NS:
                continue
            ascii_seq = window.seq_ascii
            window_bp += len(ascii_seq)
            padded = ascii_seq.ljust(WINDOW_LENGTH, b"N")
            base_rows.append(
                sequence._BASE_CODES[np.frombuffer(padded, np.uint8)].astype(np.uint8)
            )
            contig_ids.append(contig_id)
    trace.count("nn.window_bp", window_bp)
    if base_rows:
        bases = np.stack(base_rows)
    else:
        bases = np.zeros((0, WINDOW_LENGTH), dtype=np.uint8)
    return bases, np.array(contig_names), np.array(contig_ids, dtype=np.int32)


def predict_windows(
    model: igloo.IglooClassifier,
    windows: np.ndarray,
    batch_size: int = 128,
    progress: Callable[[int, int], None] | None = None,
    mesh=None,
) -> np.ndarray:
    """Run the window classifier over all windows, ``batch_size`` at a time.

    ``windows`` is the (N, 6000) base-code matrix. Each batch is copied to
    the model's device as uint8 (from pinned memory when that is the card);
    the last batch is padded with all-N windows to the full batch size.
    Returns (N, 3) float32 probabilities on the host. ``mesh``: see
    :func:`_predict_on_mesh`.
    """
    n = windows.shape[0]
    if n == 0:
        return np.zeros((0, igloo.N_CLASSES), dtype=np.float32)
    if mesh is not None:
        return _predict_on_mesh(model, windows, batch_size, progress, mesh)
    host = torch.from_numpy(np.ascontiguousarray(windows, dtype=np.uint8))
    if model.device.type == "cuda":
        host = host.pin_memory()
    n_batches = -(-n // batch_size)
    outputs = []
    with torch.inference_mode():
        for i in range(n_batches):
            batch = host[i * batch_size : (i + 1) * batch_size].to(model.device, non_blocking=True)
            if batch.shape[0] < batch_size:
                batch = torch.nn.functional.pad(batch, (0, 0, 0, batch_size - batch.shape[0]), value=igloo.N_CODE)
            # results stay on the device: the host queues batch i+1 while
            # the card runs batch i
            outputs.append(model.forward_bases(batch))
            if progress is not None:
                progress(i + 1, n_batches)
        return torch.cat(outputs)[:n].cpu().numpy()


def _replica(model: igloo.IglooClassifier, device: torch.device, replicas: dict) -> igloo.IglooClassifier:
    """``model`` on ``device``: itself there, else one copy per device,
    kept in ``replicas``."""
    if device == meshlib.canonical_device(model.device):
        return model
    if device not in replicas:
        replicas[device] = copy.deepcopy(model).to(device)
        replicas[device].device = device
    return replicas[device]


def _predict_on_mesh(model, windows, batch_size, progress, mesh) -> np.ndarray:
    """:func:`predict_windows` over the ``data`` axis of a mesh (JAX: the
    batch sharded over 'data', replicated over 'db'). The windows are cut
    into n_data contiguous blocks; this rank runs the blocks of the cells
    (g, 0) it owns, each through :func:`predict_windows` on that cell's
    device at batch_size / n_data rows (the batch size padded to a
    multiple of n_data), with one replica of the model per distinct
    device. Windows are independent, so the rows equal the unsharded run's.
    ``Mesh.gather`` gives every rank all the rows. A one-cell mesh is its
    device."""
    n_data = mesh.shape["data"]
    per_cell = meshlib.pad_to_multiple(batch_size, n_data) // n_data
    block = -(-windows.shape[0] // n_data)
    cells = [g for g in range(n_data) if (g, 0) in mesh.rank_cells]
    spans = [(g * block, min((g + 1) * block, windows.shape[0])) for g in cells]
    total = sum(-(-max(b - a, 0) // per_cell) for a, b in spans)
    replicas: dict = {}
    out = np.zeros((windows.shape[0], igloo.N_CLASSES), np.float32)
    done = 0
    for g, (a, b) in zip(cells, spans):
        if b <= a:
            continue
        cell_progress = None if progress is None else (lambda i, _n, done=done: progress(done + i, total))
        replica = _replica(model, mesh.devices[g, 0], replicas)
        out[a:b] = predict_windows(replica, windows[a:b], per_cell, cell_progress)
        done += -(-(b - a) // per_cell)
    return mesh.gather(out)


def segment_mean(window_preds: np.ndarray, contig_ids: np.ndarray, n_contigs: int) -> np.ndarray:
    """Average window predictions per contig (reference:
    nn_classification.py:320, tf.math.segment_mean)."""
    sums = np.zeros((n_contigs, window_preds.shape[1]), dtype=np.float64)
    np.add.at(sums, contig_ids, window_preds)
    counts = np.bincount(contig_ids, minlength=n_contigs).astype(np.float64)
    counts = np.maximum(counts, 1)
    return (sums / counts[:, None]).astype(np.float32)
