"""Trainable statistical NER tagger — the model-backed analyzer seam
(counterpart of transformers/ner_model.py).

Reference: core/.../utils/text/OpenNLPNameEntityTagger.scala loads binary
maxent models from models/src/main/resources/OpenNLP/*.bin. Those JVM
artifacts are not shipped here; instead this module provides the same
capability class — a trained, context-sensitive statistical tagger with a
model FILE the stage loads at construction — as an averaged perceptron
over orthographic + contextual features. `NameEntityRecognizer`
(ner.py) takes `model_path=` and falls back to the regex+gazetteer
heuristic when no model is given. A tagger's JSON file loads in either
package, and a tagger trained by either from the same corpus and seed has
the same weights.

The feature design is the standard maxent-NER set (word shape, affixes,
context words, gazetteer flags) — what lets the model tag tokens the
gazetteer has never seen ("Kowalczyk signed...") from their context and
morphology.
"""
from __future__ import annotations

import json
import re
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

_CAP_RE = re.compile(r"^[A-Z][a-z'-]+$")
_ALLCAP_RE = re.compile(r"^[A-Z]{2,}$")
_DIGIT_RE = re.compile(r"\d")

OUTSIDE = "O"


def _shape(tok: str) -> str:
    if _ALLCAP_RE.match(tok):
        return "AA"
    if _CAP_RE.match(tok):
        return "Aa"
    if _DIGIT_RE.search(tok):
        return "d"
    return "a"


def token_features(tokens: Sequence[str], i: int,
                   gazetteer: Optional[Dict[str, set]] = None) -> List[str]:
    """Sparse binary features for token i in its sentence."""
    tok = tokens[i]
    low = tok.lower()
    prev = tokens[i - 1].lower() if i > 0 else "<s>"
    nxt = tokens[i + 1].lower() if i + 1 < len(tokens) else "</s>"
    feats = [
        f"w={low}", f"shape={_shape(tok)}",
        f"suf3={low[-3:]}", f"suf4={low[-4:]}", f"pre3={low[:3]}",
        f"prev={prev}", f"next={nxt}",
        f"prevshape={_shape(tokens[i - 1]) if i > 0 else '<s>'}",
        f"nextshape={_shape(tokens[i + 1]) if i + 1 < len(tokens) else '</s>'}",
        f"shape2={_shape(tok)}+{nxt}",
        f"first={i == 0}",
    ]
    if gazetteer:
        for ent, words in gazetteer.items():
            if low in words:
                feats.append(f"gaz={ent}")
            if i > 0 and tokens[i - 1].lower() in words:
                feats.append(f"prevgaz={ent}")
    return feats


class PerceptronNerTagger:
    """Averaged perceptron sequence-less token classifier (the maxent-model
    role of the reference's OpenNLP tagger)."""

    def __init__(self, weights: Optional[Dict[str, Dict[str, float]]] = None,
                 classes: Optional[List[str]] = None,
                 gazetteer: Optional[Dict[str, List[str]]] = None):
        self.weights: Dict[str, Dict[str, float]] = weights or {}
        self.classes: List[str] = classes or []
        self.gazetteer = {k: set(v) for k, v in (gazetteer or {}).items()}

    # -- inference ---------------------------------------------------------
    def _score(self, feats: Iterable[str]) -> Dict[str, float]:
        scores = {c: 0.0 for c in self.classes}
        for f in feats:
            w = self.weights.get(f)
            if w:
                for c, v in w.items():
                    scores[c] += v
        return scores

    def predict_tokens(self, tokens: Sequence[str]) -> List[str]:
        out = []
        for i in range(len(tokens)):
            feats = token_features(tokens, i, self.gazetteer)
            scores = self._score(feats)
            best = max(scores, key=scores.get) if scores else OUTSIDE
            # unseen feature patterns score ~0 for every class: that is
            # "no evidence", not a coin-flip entity — predict outside
            if best != OUTSIDE and scores[best] <= 0.0:
                best = OUTSIDE
            out.append(best)
        return out

    # -- training ----------------------------------------------------------
    @classmethod
    def train(cls, sentences: Sequence[Sequence[Tuple[str, str]]],
              gazetteer: Optional[Dict[str, set]] = None,
              epochs: int = 8, seed: int = 0) -> "PerceptronNerTagger":
        """sentences: [(token, label)] with label OUTSIDE for plain words."""
        import numpy as np

        classes = sorted({lab for s in sentences for _, lab in s})
        gaz = {k: set(v) for k, v in (gazetteer or {}).items()}
        w: Dict[str, Dict[str, float]] = defaultdict(
            lambda: defaultdict(float))
        totals: Dict[str, Dict[str, float]] = defaultdict(
            lambda: defaultdict(float))
        stamps: Dict[str, Dict[str, int]] = defaultdict(
            lambda: defaultdict(int))
        rng = np.random.default_rng(seed)
        order = np.arange(len(sentences))
        t = 0

        def upd(feat: str, cl: str, delta: float) -> None:
            totals[feat][cl] += (t - stamps[feat][cl]) * w[feat][cl]
            stamps[feat][cl] = t
            w[feat][cl] += delta

        for _ in range(epochs):
            rng.shuffle(order)
            for si in order:
                sent = sentences[si]
                tokens = [tok for tok, _ in sent]
                for i, (tok, gold) in enumerate(sent):
                    t += 1
                    feats = token_features(tokens, i, gaz)
                    scores = {c: 0.0 for c in classes}
                    for f in feats:
                        if f in w:
                            for c, v in w[f].items():
                                scores[c] += v
                    guess = max(scores, key=scores.get)
                    if guess != gold:
                        for f in feats:
                            upd(f, gold, 1.0)
                            upd(f, guess, -1.0)
        # average
        avg: Dict[str, Dict[str, float]] = {}
        for f, per in w.items():
            row = {}
            for c, v in per.items():
                total = totals[f][c] + (t - stamps[f][c]) * v
                a = total / max(t, 1)
                if abs(a) > 1e-9:
                    row[c] = round(a, 6)
            if row:
                avg[f] = row
        return cls(weights=avg, classes=classes,
                   gazetteer={k: sorted(v) for k, v in gaz.items()})

    # -- persistence -------------------------------------------------------
    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump({"classes": self.classes, "weights": self.weights,
                       "gazetteer": {k: sorted(v)
                                     for k, v in self.gazetteer.items()}},
                      fh)

    @classmethod
    def load(cls, path: str) -> "PerceptronNerTagger":
        with open(path) as fh:
            d = json.load(fh)
        return cls(weights=d["weights"], classes=d["classes"],
                   gazetteer=d.get("gazetteer", {}))
