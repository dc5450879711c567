"""The email, URL, phone and MIME stages of the port against the JAX
package, on a seeded corpus with the awkward cases: emails with no local
part, two @ or none; URLs with userinfo, ports, localhost, queries, other
schemes and none; phones of US, GB and DE numbers with and without their
country code, trunk prefixes, letters, two plus signs, too short and too
long, with other default regions; base64 payloads of every built-in magic,
random bytes, text, undecodable strings, padding cut off, empty and
missing; and extra magic rules loaded from a file.

Tolerance: none. Every stage's column equals the JAX package's (strings,
NaN where missing), the per-row path gives the column path's rows, and the
shared functions (parse_phone, parse_phone_e164, detect_mime) return the
same values.
"""
import base64
import json

import numpy as np
import pytest

from transmogrifai_tpu.data.dataset import Dataset as JDataset
from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.transformers import text as JX
from transmogrifai_tpu.utils import uid as JU
import transmogrifai_tpu.types as JT

from torch_threads import one_torch_thread  # noqa: F401
from transmogrifai_tpu_torch.data.dataset import Dataset as PDataset
from transmogrifai_tpu_torch.features.builder import FeatureBuilder as PFB
from transmogrifai_tpu_torch.transformers import text as PX
from transmogrifai_tpu_torch.utils import uid as PU
import transmogrifai_tpu_torch.types as PT

JAX = (JFB, JU, JDataset, JT, JX)
PORT = (PFB, PU, PDataset, PT, PX)

EMAILS = ["jane.doe@example.com", "not-an-email", "@example.com", "jane@",
          "a@b@c.com", "first.last+tag@sub.example.co.uk", "x@localhost",
          "UPPER@Example.COM", "sp ace@example.com", "", None]
URLS = ["https://user:pw@example.com/a", "http://localhost:8080/x",
        "https://example.com:8443/a", "https://sub.example.com/p?q=1",
        "ftp://files.example.org/f", "mailto:x@y.com", "nope",
        "www.example.com", "HTTP://EXAMPLE.COM/", "http://", "http:///x",
        "https://[::1]:443/", "", None]
PHONES = ["(415) 555-0134", "415-555-0134", "+1 415 555 0134",
          "1-415-555-0134", "+44 20 7946 0958", "020 7946 0958",
          "+49 30 1234567", "030 1234567", "+49 (0)30 1234567",
          "555-0134", "+1 415 555 01345", "+999 1234 5678", "+12",
          "415-CALL-NOW", "++1 415 555 0134", "415+5550134",
          "+86 138 0013 8000", "", None]
REGIONS = ["US", "GB", "DE", "fr", "ZZ"]


def payloads(rng):
    heads = [m for m, _ in PX._MIME_MAGIC] + [b"BM", b"hello world"]
    out = [base64.b64encode(h + rng.bytes(8)).decode() for h in heads]
    out += [base64.b64encode(rng.bytes(20)).decode() for _ in range(5)]
    out += [base64.b64encode(b"\x89PNG\r\n").decode().rstrip("="),
            "!!not base64!!", "QUJD", "", None]
    return out


def corpus(values, n=300, seed=0):
    rng = np.random.default_rng(seed)
    return list(values) + [values[i] for i in
                           rng.integers(0, len(values), n)]


def run(pkg, tname, values, make):
    """`make(text module)`'s stage on a `tname` feature over `values`: the
    stage's column and its per-row outputs."""
    FB, U, Dataset, T, X = pkg
    U.reset_uids()
    stage = make(X).set_input(getattr(FB, tname)("v").as_predictor())
    ds = Dataset.from_features([("v", getattr(T, tname), values)])
    col = stage.transform(ds).column(stage.output_name())
    rows = [stage.transform_value(getattr(T, tname)(v)).value
            for v in values]
    return col, rows


def assert_column_same(a, b):
    assert b.kind == a.kind and b.data.dtype == a.data.dtype
    if a.data.dtype == object:
        assert list(b.data) == list(a.data)
    else:
        np.testing.assert_array_equal(b.data, a.data)


STAGES = {
    "email_domain": ("Email", EMAILS, lambda X: X.EmailToPickList()),
    "valid_email": ("Email", EMAILS, lambda X: X.ValidEmailTransformer()),
    "email_prefix": ("Email", EMAILS, lambda X: X.EmailPrefixTransformer()),
    "url_domain": ("URL", URLS, lambda X: X.UrlPartsTransformer()),
    "url_protocol": ("URL", URLS,
                     lambda X: X.UrlPartsTransformer(part="protocol")),
    "valid_url": ("URL", URLS, lambda X: X.ValidUrlTransformer()),
    "valid_url_https": ("URL", URLS, lambda X: X.ValidUrlTransformer(
        protocols=["https"])),
    "url_domain_picklist": ("URL", URLS, lambda X: X.UrlToDomainPickList()),
    "phone_valid": ("Phone", PHONES, lambda X: X.PhoneNumberParser()),
    "phone_valid_gb": ("Phone", PHONES, lambda X: X.PhoneNumberParser(
        default_region="GB")),
    "phone_valid_lenient": ("Phone", PHONES, lambda X: X.PhoneNumberParser(
        strict=False)),
    "phone_e164": ("Phone", PHONES, lambda X: X.PhoneParser()),
    "phone_e164_de": ("Phone", PHONES, lambda X: X.PhoneParser(
        default_region="DE")),
    "mime": ("Base64", None, lambda X: X.MimeTypeDetector()),
}


@pytest.mark.parametrize("name", sorted(STAGES))
def test_stage_matches_jax(name):
    tname, values, make = STAGES[name]
    if values is None:
        values = payloads(np.random.default_rng(3))
    values = corpus(values)
    (ja, jr), (pa, pr) = (run(pkg, tname, values, make)
                          for pkg in (JAX, PORT))
    assert_column_same(ja, pa)
    assert pr == jr
    # the column path (one call per distinct value) gives the rows
    want = [np.nan if v is None else float(v) for v in pr] \
        if pa.data.dtype != object else pr
    if pa.data.dtype == object:
        assert list(pa.data) == want
    else:
        np.testing.assert_array_equal(pa.data, want)


@pytest.mark.parametrize("region", REGIONS)
def test_phone_resolution_matches_jax(region):
    for raw in PHONES[:-1]:
        assert PX.parse_phone(raw, region) == JX.parse_phone(raw, region)
        assert PX.parse_phone_e164(raw, region) == \
            JX.parse_phone_e164(raw, region)
    assert PX._PHONE_REGIONS == JX._PHONE_REGIONS
    assert PX._CC_TO_REGIONS == JX._CC_TO_REGIONS


def test_mime_detection_and_extra_magic(tmp_path):
    path = tmp_path / "magic.json"
    path.write_text(json.dumps([{"magic_hex": "424d", "mime": "image/bmp"},
                                {"magic_hex": "89504e47",
                                 "mime": "image/x-custom-png"}]))
    assert PX.load_mime_magic(str(path)) == JX.load_mime_magic(str(path))
    extra = PX.load_mime_magic(str(path))
    for v in payloads(np.random.default_rng(4)):
        assert PX.detect_mime(v) == JX.detect_mime(v)
        assert PX.detect_mime(v, extra) == JX.detect_mime(v, extra)
    assert PX._MIME_MAGIC == JX._MIME_MAGIC

    def make(X):
        return X.MimeTypeDetector(model_path=str(path))
    values = corpus(payloads(np.random.default_rng(5)), n=50)
    (ja, _), (pa, pr) = (run(pkg, "Base64", values, make)
                         for pkg in (JAX, PORT))
    assert_column_same(ja, pa)
    assert "image/bmp" in pr and "image/x-custom-png" in pr
