"""Random typed-feature generators for tests (counterpart of
testkit/random_data.py).

Reference: testkit/src/main/scala/com/salesforce/op/testkit/ (16 files —
RandomReal.scala:44, RandomText, RandomIntegral, RandomBinary, RandomList,
RandomMap, RandomSet, RandomVector): distribution-parameterized infinite
streams of FeatureType values with a configurable probability of empties.

Python shape: every generator is an infinite iterator over FeatureType
instances; `take(n)` materializes a list, `with_probability_of_empty(p)`
injects missingness, `reset(seed)` makes runs reproducible.
"""
from __future__ import annotations

import string
from typing import Any, Callable, Dict, Generic, Iterator, List, Optional
from typing import Sequence, Type, TypeVar

import numpy as np

from ..types import (
    Base64, Binary, City, ComboBox, Country, Currency, Date, DateList,
    DateTime, Email, FeatureType, Geolocation, GeolocationMap, ID, Integral,
    MultiPickList, OPVector, Percent, Phone, PickList, PostalCode, Real,
    RealMap, RealNN, State, Street, Text, TextArea, TextList, TextMap, URL,
)

T = TypeVar("T", bound=FeatureType)

_FIRST_NAMES = ["Ada", "Alan", "Grace", "Edsger", "Barbara", "Donald",
                "Radia", "Vint", "Margaret", "Dennis", "Frances", "Ken"]
_LAST_NAMES = ["Lovelace", "Turing", "Hopper", "Dijkstra", "Liskov", "Knuth",
               "Perlman", "Cerf", "Hamilton", "Ritchie", "Allen", "Thompson"]
_DOMAINS = ["example.com", "mail.org", "site.net", "corp.io"]
_COUNTRIES = ["USA", "Canada", "Mexico", "France", "Germany", "Japan",
              "Brazil", "India", "Australia", "Kenya"]
_STATES = ["CA", "NY", "TX", "WA", "OR", "IL", "MA", "GA", "FL", "CO"]
_CITIES = ["Springfield", "Rivertown", "Lakeside", "Hillview", "Brookfield",
           "Fairmont", "Georgetown", "Clinton", "Salem", "Madison"]
_STREETS = ["Maple St", "Oak Ave", "Pine Rd", "Cedar Ln", "Elm Dr",
            "2nd St", "Park Blvd", "Main St", "River Rd", "Lake Ave"]


class RandomData(Generic[T]):
    """Infinite stream of FeatureType values (reference RandomData)."""

    def __init__(self, type_cls: Type[T], sample: Callable[[np.random.Generator], Any],
                 seed: int = 42):
        self.type_cls = type_cls
        self._sample = sample
        self._seed = seed
        self._rng = np.random.default_rng(seed)
        self._p_empty = 0.0

    # -- fluent config (reference withProbabilityOfEmpty) ------------------
    def with_probability_of_empty(self, p: float) -> "RandomData[T]":
        self._p_empty = float(p)
        return self

    def reset(self, seed: Optional[int] = None) -> "RandomData[T]":
        self._seed = self._seed if seed is None else seed
        self._rng = np.random.default_rng(self._seed)
        return self

    # -- stream ------------------------------------------------------------
    def __iter__(self) -> Iterator[T]:
        while True:
            yield self.next_value()

    def next_value(self) -> T:
        if self._p_empty > 0 and self._rng.uniform() < self._p_empty:
            return self.type_cls.empty()
        return self.type_cls(self._sample(self._rng))

    def take(self, n: int) -> List[T]:
        return [self.next_value() for _ in range(n)]

    def limit(self, n: int) -> List[T]:  # reference naming
        return self.take(n)


class RandomReal:
    """Reference RandomReal.scala:44 — distribution factories."""

    @staticmethod
    def normal(mean: float = 0.0, sigma: float = 1.0,
               of: Type[FeatureType] = Real, seed: int = 42) -> RandomData:
        return RandomData(of, lambda r: float(r.normal(mean, sigma)), seed)

    @staticmethod
    def uniform(lo: float = 0.0, hi: float = 1.0,
                of: Type[FeatureType] = Real, seed: int = 42) -> RandomData:
        return RandomData(of, lambda r: float(r.uniform(lo, hi)), seed)

    @staticmethod
    def poisson(lam: float = 1.0, of: Type[FeatureType] = Real,
                seed: int = 42) -> RandomData:
        return RandomData(of, lambda r: float(r.poisson(lam)), seed)

    @staticmethod
    def exponential(scale: float = 1.0, of: Type[FeatureType] = Real,
                    seed: int = 42) -> RandomData:
        return RandomData(of, lambda r: float(r.exponential(scale)), seed)

    @staticmethod
    def gamma(shape: float = 2.0, scale: float = 1.0,
              of: Type[FeatureType] = Real, seed: int = 42) -> RandomData:
        return RandomData(of, lambda r: float(r.gamma(shape, scale)), seed)

    @staticmethod
    def lognormal(mean: float = 0.0, sigma: float = 1.0,
                  of: Type[FeatureType] = Real, seed: int = 42) -> RandomData:
        return RandomData(of, lambda r: float(r.lognormal(mean, sigma)), seed)

    @staticmethod
    def weibull(a: float = 1.5, of: Type[FeatureType] = Real,
                seed: int = 42) -> RandomData:
        return RandomData(of, lambda r: float(r.weibull(a)), seed)

    # non-null variants
    @staticmethod
    def normal_nn(mean: float = 0.0, sigma: float = 1.0,
                  seed: int = 42) -> RandomData:
        return RandomData(RealNN, lambda r: float(r.normal(mean, sigma)), seed)

    @staticmethod
    def currencies(lo: float = 0.0, hi: float = 1000.0,
                   seed: int = 42) -> RandomData:
        return RandomData(Currency, lambda r: round(float(r.uniform(lo, hi)), 2),
                          seed)

    @staticmethod
    def percents(seed: int = 42) -> RandomData:
        return RandomData(Percent, lambda r: float(r.uniform(0, 100)), seed)


class RandomIntegral:
    """Reference RandomIntegral.scala."""

    @staticmethod
    def integrals(lo: int = 0, hi: int = 100, seed: int = 42) -> RandomData:
        return RandomData(Integral, lambda r: int(r.integers(lo, hi)), seed)

    @staticmethod
    def dates(start_ms: int = 1_500_000_000_000, step_ms: int = 86_400_000,
              seed: int = 42) -> RandomData:
        return RandomData(
            Date, lambda r: int(start_ms + r.integers(0, 1000) * step_ms),
            seed)

    @staticmethod
    def datetimes(start_ms: int = 1_500_000_000_000, seed: int = 42
                  ) -> RandomData:
        return RandomData(
            DateTime,
            lambda r: int(start_ms + r.integers(0, 10**9)), seed)


class RandomBinary:
    """Reference RandomBinary.scala — Bernoulli(p)."""

    def __new__(cls, probability_of_success: float = 0.5, seed: int = 42
                ) -> RandomData:
        p = probability_of_success
        return RandomData(Binary, lambda r: bool(r.uniform() < p), seed)


def _rand_str(r: np.random.Generator, k: int = 8) -> str:
    letters = np.array(list(string.ascii_lowercase))
    return "".join(r.choice(letters, size=k))


class RandomText:
    """Reference RandomText.scala — realistic typed text streams."""

    @staticmethod
    def strings(min_len: int = 3, max_len: int = 12, seed: int = 42
                ) -> RandomData:
        return RandomData(
            Text, lambda r: _rand_str(r, int(r.integers(min_len, max_len + 1))),
            seed)

    @staticmethod
    def textareas(sentences: int = 3, seed: int = 42) -> RandomData:
        def sample(r):
            return ". ".join(
                " ".join(_rand_str(r, int(r.integers(2, 9)))
                         for _ in range(int(r.integers(4, 10))))
                for _ in range(sentences))
        return RandomData(TextArea, sample, seed)

    @staticmethod
    def names(seed: int = 42) -> RandomData:
        return RandomData(
            Text, lambda r: f"{r.choice(_FIRST_NAMES)} {r.choice(_LAST_NAMES)}",
            seed)

    @staticmethod
    def emails(domain: Optional[str] = None, seed: int = 42) -> RandomData:
        return RandomData(
            Email,
            lambda r: f"{_rand_str(r, 6)}@{domain or r.choice(_DOMAINS)}",
            seed)

    @staticmethod
    def urls(seed: int = 42) -> RandomData:
        return RandomData(
            URL, lambda r: f"https://{_rand_str(r, 6)}.{r.choice(_DOMAINS)}",
            seed)

    @staticmethod
    def phones(seed: int = 42) -> RandomData:
        return RandomData(
            Phone, lambda r: "+1" + "".join(str(d) for d in
                                            r.integers(0, 10, size=10)),
            seed)

    @staticmethod
    def ids(seed: int = 42) -> RandomData:
        return RandomData(ID, lambda r: _rand_str(r, 12), seed)

    @staticmethod
    def countries(seed: int = 42) -> RandomData:
        return RandomData(Country, lambda r: str(r.choice(_COUNTRIES)), seed)

    @staticmethod
    def states(seed: int = 42) -> RandomData:
        return RandomData(State, lambda r: str(r.choice(_STATES)), seed)

    @staticmethod
    def cities(seed: int = 42) -> RandomData:
        return RandomData(City, lambda r: str(r.choice(_CITIES)), seed)

    @staticmethod
    def streets(seed: int = 42) -> RandomData:
        return RandomData(
            Street, lambda r: f"{int(r.integers(1, 9999))} {r.choice(_STREETS)}",
            seed)

    @staticmethod
    def postal_codes(seed: int = 42) -> RandomData:
        return RandomData(
            PostalCode, lambda r: f"{int(r.integers(10000, 99999))}", seed)

    @staticmethod
    def pick_lists(domain: Sequence[str], seed: int = 42) -> RandomData:
        dom = list(domain)
        return RandomData(PickList, lambda r: str(r.choice(dom)), seed)

    @staticmethod
    def combo_boxes(domain: Sequence[str], seed: int = 42) -> RandomData:
        dom = list(domain)
        return RandomData(ComboBox, lambda r: str(r.choice(dom)), seed)

    @staticmethod
    def base64(n_bytes: int = 24, seed: int = 42) -> RandomData:
        import base64 as b64
        return RandomData(
            Base64,
            lambda r: b64.b64encode(r.bytes(n_bytes)).decode("ascii"), seed)


class RandomList:
    """Reference RandomList.scala."""

    @staticmethod
    def of_texts(min_len: int = 0, max_len: int = 5, seed: int = 42
                 ) -> RandomData:
        return RandomData(
            TextList,
            lambda r: [_rand_str(r, 6)
                       for _ in range(int(r.integers(min_len, max_len + 1)))],
            seed)

    @staticmethod
    def of_dates(start_ms: int = 1_500_000_000_000, max_len: int = 5,
                 seed: int = 42) -> RandomData:
        return RandomData(
            DateList,
            lambda r: [int(start_ms + x)
                       for x in r.integers(0, 10**9,
                                           size=int(r.integers(0, max_len + 1)))],
            seed)


class RandomSet:
    """Reference RandomSet.scala — MultiPickList draws."""

    @staticmethod
    def of(domain: Sequence[str], min_len: int = 0, max_len: int = 3,
           seed: int = 42) -> RandomData:
        dom = list(domain)
        return RandomData(
            MultiPickList,
            lambda r: set(r.choice(dom, size=min(
                int(r.integers(min_len, max_len + 1)), len(dom)),
                replace=False).tolist()),
            seed)


class RandomMap:
    """Reference RandomMap.scala — keyed draws of a base generator."""

    @staticmethod
    def of_reals(keys: Sequence[str], seed: int = 42) -> RandomData:
        ks = list(keys)
        return RandomData(
            RealMap,
            lambda r: {k: float(r.normal()) for k in ks
                       if r.uniform() > 0.2},
            seed)

    @staticmethod
    def of_texts(keys: Sequence[str], seed: int = 42) -> RandomData:
        ks = list(keys)
        return RandomData(
            TextMap,
            lambda r: {k: _rand_str(r, 6) for k in ks if r.uniform() > 0.2},
            seed)

    @staticmethod
    def of_geolocations(keys: Sequence[str], seed: int = 42) -> RandomData:
        ks = list(keys)

        def sample(r):
            return {k: [float(r.uniform(-90, 90)),
                        float(r.uniform(-180, 180)), 1.0]
                    for k in ks if r.uniform() > 0.2}
        return RandomData(GeolocationMap, sample, seed)


class RandomVector:
    """Reference RandomVector.scala — dense vectors from a distribution."""

    @staticmethod
    def normal(dim: int, mean: float = 0.0, sigma: float = 1.0,
               seed: int = 42) -> RandomData:
        return RandomData(
            OPVector,
            lambda r: r.normal(mean, sigma, size=dim).astype(np.float32),
            seed)

    @staticmethod
    def dense(dim: int, lo: float = 0.0, hi: float = 1.0, seed: int = 42
              ) -> RandomData:
        return RandomData(
            OPVector,
            lambda r: r.uniform(lo, hi, size=dim).astype(np.float32), seed)


class RandomGeolocation:
    def __new__(cls, seed: int = 42) -> RandomData:
        return RandomData(
            Geolocation,
            lambda r: [float(r.uniform(-90, 90)),
                       float(r.uniform(-180, 180)),
                       float(r.integers(1, 10))],
            seed)
