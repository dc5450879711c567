"""Name-entity recognition stage (counterpart of transformers/ner.py).

Reference: core/.../impl/feature/NameEntityRecognizer.scala backed by
core/.../utils/text/{OpenNLPAnalyzer, OpenNLPNameEntityTagger,
OpenNLPSentenceSplitter}.scala — OpenNLP statistical taggers producing a
MultiPickListMap of token -> entity-type sets.

The JVM model files cannot (and should not) be reproduced here; this stage
keeps the same output contract with a deterministic host-side
regex + gazetteer + orthography tagger: DATE/TIME/MONEY/PERCENTAGE via
pattern rules, LOCATION via a country/major-city gazetteer, ORGANIZATION
via corporate suffixes, PERSON via honorifics and capitalized-sequence
heuristics. Swappable: pass `extra_gazetteers` to extend entity lexicons.
Host Python, copied with the JAX package's gazetteers and patterns.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Set

from ..stages.params import Param
from ..types import MultiPickListMap, Text
from .text import DistinctValueTransformer

# -- lexicons ---------------------------------------------------------------

_COUNTRIES = {
    "afghanistan", "argentina", "australia", "austria", "bangladesh",
    "belgium", "brazil", "canada", "chile", "china", "colombia", "cuba",
    "denmark", "egypt", "england", "ethiopia", "finland", "france",
    "germany", "ghana", "greece", "india", "indonesia", "iran", "iraq",
    "ireland", "israel", "italy", "jamaica", "japan", "kenya", "korea",
    "mexico", "morocco", "nepal", "netherlands", "nigeria", "norway",
    "pakistan", "peru", "philippines", "poland", "portugal", "romania",
    "russia", "scotland", "singapore", "spain", "sweden", "switzerland",
    "taiwan", "thailand", "turkey", "uganda", "ukraine", "usa", "venezuela",
    "vietnam", "wales", "zimbabwe",
}
_CITIES = {
    "amsterdam", "athens", "atlanta", "austin", "bangkok", "barcelona",
    "beijing", "berlin", "boston", "cairo", "chicago", "dallas", "delhi",
    "denver", "dubai", "dublin", "geneva", "houston", "istanbul", "jakarta",
    "karachi", "lagos", "lima", "lisbon", "london", "madrid", "manila",
    "melbourne", "miami", "moscow", "mumbai", "munich", "nairobi", "osaka",
    "oslo", "paris", "prague", "rome", "santiago", "seattle", "seoul",
    "shanghai", "singapore", "stockholm", "sydney", "taipei", "tokyo",
    "toronto", "vienna", "warsaw", "zurich",
}
_ORG_SUFFIXES = {
    "inc", "corp", "ltd", "llc", "plc", "gmbh", "co", "company",
    "corporation", "incorporated", "limited", "group", "holdings",
    "partners", "ventures", "labs", "bank", "university", "institute",
}
_HONORIFICS = {"mr", "mrs", "ms", "miss", "dr", "prof", "sir", "madam",
               "president", "senator", "judge", "captain"}
_COMMON_FIRST_NAMES = {
    "james", "john", "robert", "michael", "william", "david", "richard",
    "joseph", "thomas", "charles", "mary", "patricia", "jennifer", "linda",
    "elizabeth", "barbara", "susan", "jessica", "sarah", "karen", "nancy",
    "maria", "ana", "juan", "carlos", "jose", "luis", "wei", "li", "chen",
    "yuki", "hiroshi", "ahmed", "fatima", "mohammed", "aisha", "olga",
    "ivan", "pierre", "marie", "hans", "greta", "paolo", "giulia",
}

_DATE_RE = re.compile(
    r"^(\d{1,4}[-/]\d{1,2}[-/]\d{1,4}"
    # month names must match exactly (full or 3-letter form): the old
    # open-ended (mar)[a-z]* tail tagged words like 'Maria' as Date
    r"|(january|february|march|april|may|june|july|august|september"
    r"|october|november|december"
    r"|jan|feb|mar|apr|jun|jul|aug|sep|sept|oct|nov|dec)\.?,?"
    r"|\d{4}|\d{1,2}(st|nd|rd|th))$", re.IGNORECASE)
_TIME_RE = re.compile(r"^\d{1,2}:\d{2}(:\d{2})?(am|pm)?$|^\d{1,2}(am|pm)$",
                      re.IGNORECASE)
_MONEY_RE = re.compile(r"^[$€£¥]\d[\d,.]*[kmb]?$|^\d[\d,.]*[$€£¥]$")
_PERCENT_RE = re.compile(r"^\d[\d,.]*%$")
_WORD_SPLIT_RE = re.compile(r"[^\w$€£¥%:/,.'-]+", re.UNICODE)
_CAP_RE = re.compile(r"^[A-Z][a-z'-]+$")


# built once at import: per-row tagging must not re-union the gazetteers
_BASE_LEXICON: Dict[str, Set[str]] = {
    "Location": _COUNTRIES | _CITIES,
    "Organization": set(),
    "Person": set(),
}


def merge_lexicon(extra: Optional[Dict[str, Set[str]]]
                  ) -> Dict[str, Set[str]]:
    """Base gazetteers + user-supplied entity lexicons (lowercased)."""
    if not extra:
        return _BASE_LEXICON
    lex = {ent: set(words) for ent, words in _BASE_LEXICON.items()}
    for ent, words in extra.items():
        lex.setdefault(ent, set())
        lex[ent] |= {w.lower() for w in words}
    return lex


def _token_tags(tok: str, lex: Dict[str, Set[str]]) -> tuple:
    """What one token says alone: (lowercase, its entity types from the
    patterns and the lexicon in tagging order, capitalized)."""
    low = tok.lower()
    ents = [ent for ent, rule in (("Date", _DATE_RE), ("Time", _TIME_RE),
                                  ("Money", _MONEY_RE),
                                  ("Percentage", _PERCENT_RE))
            if rule.match(tok)]
    ents += [ent for ent, words in lex.items() if low in words]
    return low, ents, bool(_CAP_RE.match(tok))


def tag_tokens(text: Optional[str],
               extra: Optional[Dict[str, Set[str]]] = None,
               lexicon: Optional[Dict[str, Set[str]]] = None,
               tagger=None, memo: Optional[Dict[str, tuple]] = None
               ) -> Dict[str, List[str]]:
    """Tag a sentence: token -> sorted entity-type list (one entry per
    distinct tagged token, matching the reference tagger's token->set map).
    Callers tagging many rows should pass a prebuilt `lexicon`
    (merge_lexicon(extra)) so gazetteers merge once, not per row, and may
    pass one `memo` dict for all of them (for that lexicon), so each
    distinct token is matched against the patterns and gazetteers once.

    With a trained `tagger` (ner_model.PerceptronNerTagger — the
    OpenNLP-model slot), Person/Organization/Location come from the model
    while the numeric entity classes (Date/Time/Money/Percentage) stay on
    the deterministic regexes, mirroring the reference's split between
    statistical and rule-based tagging."""
    if not text:
        return {}
    lex = lexicon if lexicon is not None else merge_lexicon(extra)
    raw = [t.strip(".,") for t in _WORD_SPLIT_RE.split(text)]
    raw = [t for t in raw if t]
    tags: Dict[str, Set[str]] = {}

    def add(tok: str, ent: str) -> None:
        tags.setdefault(tok, set()).add(ent)

    if tagger is not None:
        from .ner_model import OUTSIDE
        for tok, lab in zip(raw, tagger.predict_tokens(raw)):
            # numeric-shaped tokens belong to the regex classes below; the
            # statistical tagger only owns Person/Organization/Location
            if lab != OUTSIDE and not any(c.isdigit() for c in tok):
                add(tok, lab)
            if _DATE_RE.match(tok):
                add(tok, "Date")
            if _TIME_RE.match(tok):
                add(tok, "Time")
            if _MONEY_RE.match(tok):
                add(tok, "Money")
            if _PERCENT_RE.match(tok):
                add(tok, "Percentage")
        return {tok: sorted(ents) for tok, ents in tags.items()}

    if memo is None:
        memo = {}
    info = []
    for tok in raw:
        got = memo.get(tok)
        if got is None:
            got = memo[tok] = _token_tags(tok, lex)
        info.append(got)
    for i, tok in enumerate(raw):
        low, ents, is_cap = info[i]
        for ent in ents:
            add(tok, ent)
        if low in _ORG_SUFFIXES and i > 0 and info[i - 1][2]:
            # "Acme Corp" -> both tokens Organization
            add(raw[i - 1], "Organization")
            add(tok, "Organization")
        prev_low = info[i - 1][0] if i > 0 else ""
        if is_cap and (low in _COMMON_FIRST_NAMES
                       or prev_low in _HONORIFICS):
            add(tok, "Person")
            # capitalized successor of a tagged first/honorific name is the
            # surname ("Dr Smith", "Maria Garcia")
            if i + 1 < len(raw) and info[i + 1][2]:
                add(raw[i + 1], "Person")

    return {tok: sorted(ents) for tok, ents in tags.items()}


class NameEntityRecognizer(DistinctValueTransformer):
    """Text -> MultiPickListMap of token -> entity types (reference
    NameEntityRecognizer.scala output contract)."""

    input_types = (Text,)
    output_type = MultiPickListMap

    @classmethod
    def _declare_params(cls):
        return [Param("extra_gazetteers",
                      "entity -> extra lexicon words", None),
                Param("model_path", "trained PerceptronNerTagger JSON "
                      "(OpenNLP-model slot); None = heuristic tagger", None)]

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(params.pop("operation_name", "ner"), uid=uid,
                         **params)
        self._lexicon: Optional[Dict[str, Set[str]]] = None
        self._tagger = None
        self._tagger_loaded = False
        self._memo: Optional[Dict[str, tuple]] = None

    def _lex(self) -> Dict[str, Set[str]]:
        if self._lexicon is None:
            extra = self.get_param("extra_gazetteers")
            self._lexicon = merge_lexicon(
                {k: set(v) for k, v in extra.items()} if extra else None)
        return self._lexicon

    def _model(self):
        if not self._tagger_loaded:
            self._tagger_loaded = True
            path = self.get_param("model_path")
            if path:
                from .ner_model import PerceptronNerTagger
                self._tagger = PerceptronNerTagger.load(path)
        return self._tagger

    def transform_columns(self, *cols):
        # one token memo for the column's rows (a token's own tags depend
        # on the token and the lexicon alone)
        self._memo = {}
        try:
            return super().transform_columns(*cols)
        finally:
            self._memo = None

    def transform_value(self, *vals):
        return MultiPickListMap(tag_tokens(vals[0].value,
                                           lexicon=self._lex(),
                                           tagger=self._model(),
                                           memo=self._memo))

    def save_args(self) -> Dict[str, Any]:
        d = super().save_args()
        extra = self.get_param("extra_gazetteers")
        d.update(extra_gazetteers={k: sorted(v) for k, v in extra.items()}
                 if extra else None,
                 model_path=self.get_param("model_path"))
        return d
