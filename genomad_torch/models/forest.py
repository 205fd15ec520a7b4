"""Gradient-boosted tree ensemble inference (XGBoost-model compatible).

Port of ``genomad_tpu/models/forest.py``. The UBJSON codec, ``Forest``,
``predict_margin_np``, ``synthetic_forest``, ``write_ubj`` and
``load_forest`` are copies; ``Forest.predict_margin`` runs the JAX
package's lock-step descent (``_predict_margin_jit``) in PyTorch on
``device``: every (sample, tree) pair descends its tree for ``max_depth``
steps by gathers and compares (NaN goes to ``default_left``, ``x < thr``
goes left), then the per-class margins are ``leaf_value @
one_hot(tree_class)`` in f32 plus ``base_score``. This is plain PyTorch on
the card: JAX runs it as XLA, with no Pallas kernel.

Replaces the reference's xgboost C++ dependency
(genomad/modules/marker_classification.py:679-686: Booster on
decision_forest.ubj, predict(output_margin=True) -> softmax(T=2)).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from genomad_torch.device import disable_tf32, resolve_device

# ---------------------------------------------------------------------------
# UBJSON
# ---------------------------------------------------------------------------

_INT_TYPES = {
    ord("i"): ("<b", 1),
    ord("U"): ("<B", 1),
    ord("I"): ("<h", 2),
    ord("l"): ("<i", 4),
    ord("L"): ("<q", 8),
}
_FLOAT_TYPES = {ord("d"): ("<f", 4), ord("D"): ("<d", 8)}


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def byte(self) -> int:
        b = self.data[self.pos]
        self.pos += 1
        return b

    def peek(self) -> int:
        return self.data[self.pos]

    def scalar(self, marker: int):
        if marker in _INT_TYPES:
            fmt, size = _INT_TYPES[marker]
        elif marker in _FLOAT_TYPES:
            fmt, size = _FLOAT_TYPES[marker]
        else:
            raise ValueError(f"unsupported UBJSON scalar marker {chr(marker)!r} at {self.pos}")
        value = struct.unpack_from(fmt, self.data, self.pos)[0]
        self.pos += size
        return value

    def length(self) -> int:
        return self.scalar(self.byte())

    def string(self) -> str:
        n = self.length()
        s = self.data[self.pos : self.pos + n].decode("utf-8")
        self.pos += n
        return s

    def value(self, marker: int | None = None):
        if marker is None:
            marker = self.byte()
        while marker == ord("N"):  # UBJSON no-op: valid wherever a value is
            marker = self.byte()
        if marker in _INT_TYPES or marker in _FLOAT_TYPES:
            return self.scalar(marker)
        if marker == ord("S"):
            return self.string()
        if marker == ord("C"):
            return chr(self.byte())
        if marker == ord("T"):
            return True
        if marker == ord("F"):
            return False
        if marker == ord("Z"):
            return None
        if marker == ord("["):
            return self.array()
        if marker == ord("{"):
            return self.object()
        raise ValueError(f"unsupported UBJSON marker {chr(marker)!r} at {self.pos}")

    def array(self):
        item_type = None
        count = None
        if self.peek() == ord("$"):
            self.byte()
            item_type = self.byte()
        if self.peek() == ord("#"):
            self.byte()
            count = self.length()
        if count is not None and item_type is not None:
            if item_type in _INT_TYPES or item_type in _FLOAT_TYPES:
                fmt, size = (_INT_TYPES | _FLOAT_TYPES)[item_type]
                arr = np.frombuffer(
                    self.data, dtype=np.dtype(fmt), count=count, offset=self.pos
                ).copy()
                self.pos += size * count
                return arr
            return [self.value(item_type) for _ in range(count)]
        if count is not None:
            return [self.value() for _ in range(count)]
        out = []
        while self.peek() != ord("]"):
            if self.peek() == ord("N"):
                self.byte()
                continue
            out.append(self.value())
        self.byte()
        return out

    def object(self):
        item_type = None
        count = None
        if self.peek() == ord("$"):
            self.byte()
            item_type = self.byte()
        if self.peek() == ord("#"):
            self.byte()
            count = self.length()
        out = {}
        if count is not None:
            for _ in range(count):
                # key must be read BEFORE the value: Python evaluates the
                # RHS of ``out[k] = v`` first, so a single-expression form
                # parsed count-optimized objects value-before-key
                key = self.string()
                out[key] = self.value(item_type)
            return out
        while self.peek() != ord("}"):
            if self.peek() == ord("N"):
                self.byte()
                continue
            key = self.string()
            out[key] = self.value()
        self.byte()
        return out


def parse_ubjson(data: bytes):
    return _Reader(data).value()


def encode_ubjson(obj) -> bytes:
    """Minimal UBJSON encoder (used to write model files and in tests)."""
    out = bytearray()

    def write_int(v: int):
        out.append(ord("l") if -(2**31) <= v < 2**31 else ord("L"))
        out.extend(struct.pack("<i" if -(2**31) <= v < 2**31 else "<q", v))

    def write(o):
        if o is None:
            out.append(ord("Z"))
        elif isinstance(o, bool):
            out.append(ord("T") if o else ord("F"))
        elif isinstance(o, (int, np.integer)):
            write_int(int(o))
        elif isinstance(o, (float, np.floating)):
            out.append(ord("D"))
            out.extend(struct.pack("<d", float(o)))
        elif isinstance(o, str):
            out.append(ord("S"))
            write_int(len(o.encode()))
            out.extend(o.encode())
        elif isinstance(o, np.ndarray) and o.dtype == np.float32:
            out.extend(b"[$d#")
            write_int(o.size)
            out.extend(o.astype("<f").tobytes())
        elif isinstance(o, np.ndarray) and o.dtype in (np.int32, np.int64):
            out.extend(b"[$l#")
            write_int(o.size)
            out.extend(o.astype("<i").tobytes())
        elif isinstance(o, (list, tuple, np.ndarray)):
            out.append(ord("["))
            for item in o:
                write(item)
            out.append(ord("]"))
        elif isinstance(o, dict):
            out.append(ord("{"))
            for k, v in o.items():
                # object keys: length-prefixed strings without the 'S' marker
                write_int(len(k.encode()))
                out.extend(k.encode())
                write(v)
            out.append(ord("}"))
        else:
            raise TypeError(f"cannot encode {type(o)}")

    write(obj)
    return bytes(out)


# ---------------------------------------------------------------------------
# Forest representation + evaluation
# ---------------------------------------------------------------------------


@dataclass
class Forest:
    """Packed forest: (T, M) node tables padded with leaf self-loops."""

    feature: np.ndarray  # int32 (T, M)
    threshold: np.ndarray  # float32 (T, M)
    left: np.ndarray  # int32 (T, M)
    right: np.ndarray  # int32 (T, M)
    is_leaf: np.ndarray  # bool (T, M)
    value: np.ndarray  # float32 (T, M) leaf values
    default_left: np.ndarray  # bool (T, M)
    tree_class: np.ndarray  # int32 (T,) class id per tree
    n_classes: int
    max_depth: int
    base_score: float = 0.5
    n_features: int = 0

    @classmethod
    def from_ubj(cls, path: Path) -> "Forest":
        model = parse_ubjson(Path(path).read_bytes())
        learner = model["learner"]
        n_classes = int(learner["learner_model_param"]["num_class"]) or 1
        base_score = float(learner["learner_model_param"]["base_score"])
        gb = learner["gradient_booster"]["model"]
        trees = gb["trees"]
        tree_class = np.asarray(gb["tree_info"], dtype=np.int32)
        return cls.from_node_lists(
            [
                {
                    "split_indices": np.asarray(t["split_indices"], np.int32),
                    "split_conditions": np.asarray(t["split_conditions"], np.float32),
                    "left_children": np.asarray(t["left_children"], np.int32),
                    "right_children": np.asarray(t["right_children"], np.int32),
                    "default_left": np.asarray(t["default_left"], np.int32),
                }
                for t in trees
            ],
            tree_class,
            n_classes,
            base_score,
        )

    @classmethod
    def from_node_lists(cls, trees, tree_class, n_classes, base_score=0.5) -> "Forest":
        T = len(trees)
        M = max(len(t["left_children"]) for t in trees)
        feature = np.zeros((T, M), np.int32)
        threshold = np.zeros((T, M), np.float32)
        left = np.zeros((T, M), np.int32)
        right = np.zeros((T, M), np.int32)
        is_leaf = np.ones((T, M), bool)
        value = np.zeros((T, M), np.float32)
        default_left = np.zeros((T, M), bool)
        max_depth = 1
        n_features = 0
        for i, t in enumerate(trees):
            n = len(t["left_children"])
            lc, rc = t["left_children"], t["right_children"]
            leaf = lc == -1
            feature[i, :n] = np.where(leaf, 0, t["split_indices"])
            threshold[i, :n] = t["split_conditions"]
            # leaves self-loop so the lock-step descent is a fixed-point
            left[i, :n] = np.where(leaf, np.arange(n), lc)
            right[i, :n] = np.where(leaf, np.arange(n), rc)
            is_leaf[i, :n] = leaf
            value[i, :n] = np.where(leaf, t["split_conditions"], 0.0)
            default_left[i, :n] = t["default_left"].astype(bool)
            if (~leaf).any():
                n_features = max(n_features, int(t["split_indices"][~leaf].max()) + 1)
            # depth of tree i
            depth = np.zeros(n, np.int32)
            for node in range(n):
                if not leaf[node]:
                    depth[lc[node]] = depth[node] + 1
                    depth[rc[node]] = depth[node] + 1
            max_depth = max(max_depth, int(depth.max()) + 1)
        return cls(
            feature, threshold, left, right, is_leaf, value, default_left,
            np.asarray(tree_class, np.int32), n_classes, max_depth, base_score, n_features,
        )

    # -- evaluation ---------------------------------------------------------

    def predict_margin_np(self, X: np.ndarray) -> np.ndarray:
        """Reference scalar evaluator (oracle for tests)."""
        X = np.asarray(X, np.float32)
        out = np.full((X.shape[0], self.n_classes), self.base_score, np.float64)
        for i, x in enumerate(X):
            for t in range(self.feature.shape[0]):
                node = 0
                while not self.is_leaf[t, node]:
                    f = self.feature[t, node]
                    if np.isnan(x[f]):
                        node = self.left[t, node] if self.default_left[t, node] else self.right[t, node]
                    elif x[f] < self.threshold[t, node]:
                        node = self.left[t, node]
                    else:
                        node = self.right[t, node]
                out[i, self.tree_class[t]] += self.value[t, node]
        return out.astype(np.float32)

    def predict_margin(self, X: np.ndarray, device=None) -> np.ndarray:
        """Vectorized evaluator: lock-step descent over (sample, tree) on
        ``device`` (None = the card; raises without one). (N, n_classes)
        float32 margins."""
        device = resolve_device(device)
        disable_tf32()  # the f32 margin product is full f32, as JAX's
        X = torch.as_tensor(np.asarray(X, np.float32), device=device)
        margins = _predict_margin(self, X)
        return margins.cpu().numpy() + self.base_score


def _predict_margin(forest: Forest, X: torch.Tensor) -> torch.Tensor:
    """(N, F) f32 features on the forest's device -> (N, n_classes) f32
    margins without ``base_score`` (the JAX ``_predict_margin_jit``)."""
    device = X.device
    T, M = forest.feature.shape
    N = X.shape[0]

    def table(a):
        return torch.as_tensor(a, device=device).reshape(-1)

    feature, threshold = table(forest.feature).long(), table(forest.threshold)
    left, right = table(forest.left).long(), table(forest.right).long()
    default_left = table(forest.default_left)
    offsets = torch.arange(T, device=device) * M  # node n of tree t is entry t * M + n
    node = torch.zeros((N, T), dtype=torch.long, device=device)
    for _ in range(forest.max_depth):
        flat = node + offsets
        x = torch.gather(X, 1, feature[flat])
        go_left = torch.where(torch.isnan(x), default_left[flat], x < threshold[flat])
        node = torch.where(go_left, left[flat], right[flat])
    leaf_value = table(forest.value)[node + offsets]  # (N, T)
    one_hot = torch.nn.functional.one_hot(torch.as_tensor(forest.tree_class, device=device).long(), forest.n_classes)
    return leaf_value @ one_hot.to(leaf_value.dtype)  # (N, C)


# ---------------------------------------------------------------------------
# Synthetic forest + model file writer (tests / missing-asset fallback)
# ---------------------------------------------------------------------------


def synthetic_forest(seed: int = 0, n_trees: int = 30, n_features: int = 25, n_classes: int = 3, depth: int = 4) -> Forest:
    """Random complete-binary-tree forest with deterministic weights."""
    rng = np.random.default_rng(seed)
    trees = []
    n_internal = 2**depth - 1
    n_nodes = 2 ** (depth + 1) - 1
    for _ in range(n_trees):
        lc = np.array([2 * i + 1 if i < n_internal else -1 for i in range(n_nodes)], np.int32)
        rc = np.array([2 * i + 2 if i < n_internal else -1 for i in range(n_nodes)], np.int32)
        cond = np.where(
            lc == -1,
            rng.normal(scale=0.1, size=n_nodes),
            rng.uniform(0, 1, size=n_nodes),
        ).astype(np.float32)
        trees.append(
            {
                "split_indices": rng.integers(0, n_features, n_nodes).astype(np.int32),
                "split_conditions": cond,
                "left_children": lc,
                "right_children": rc,
                "default_left": rng.integers(0, 2, n_nodes).astype(np.int32),
            }
        )
    tree_class = np.arange(n_trees, dtype=np.int32) % n_classes
    return Forest.from_node_lists(trees, tree_class, n_classes)


def write_ubj(forest: Forest, path: Path) -> None:
    """Serialize a Forest back to the XGBoost UBJSON schema (subset)."""
    trees = []
    T, M = forest.feature.shape
    for t in range(T):
        n = M
        lc = np.where(forest.is_leaf[t], -1, forest.left[t]).astype(np.int32)
        rc = np.where(forest.is_leaf[t], -1, forest.right[t]).astype(np.int32)
        cond = np.where(forest.is_leaf[t], forest.value[t], forest.threshold[t]).astype(np.float32)
        trees.append(
            {
                "base_weights": cond,
                "default_left": forest.default_left[t].astype(np.int32),
                "id": t,
                "left_children": lc,
                "right_children": rc,
                "split_conditions": cond,
                "split_indices": forest.feature[t].astype(np.int32),
            }
        )
    model = {
        "learner": {
            "gradient_booster": {
                "model": {
                    "gbtree_model_param": {"num_trees": str(T)},
                    "tree_info": forest.tree_class.astype(np.int32),
                    "trees": trees,
                },
                "name": "gbtree",
            },
            "learner_model_param": {
                "base_score": f"{forest.base_score}",
                "num_class": str(forest.n_classes),
                "num_feature": str(forest.n_features),
            },
            "objective": {"name": "multi:softprob"},
        },
        "version": [2, 0, 0],
    }
    Path(path).write_bytes(encode_ubjson(model))


def load_forest(console=None) -> Forest:
    """Load the decision forest from the bundled model, or fall back to a
    deterministic synthetic forest (tests/benchmarks only)."""
    from genomad_torch.paths import GenomadData

    if GenomadData.decision_forest_file.exists():
        return Forest.from_ubj(GenomadData.decision_forest_file)
    if console is not None:
        console.warning(
            "decision_forest.ubj not found — falling back to a synthetic "
            "forest. Marker-classification scores will NOT be meaningful."
        )
    return synthetic_forest(seed=0)
