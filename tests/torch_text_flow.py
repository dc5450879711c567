"""Seeded text records and the text dsl's stages on them, built the same
way in either package (its FeatureBuilder): the port's text tests run both
packages on these.

`text_records` gives a Text `t` (support-ticket sentences in English with
German, French, Spanish, Russian and Japanese ones, names, places,
organisations, dates, money, percentages and times; underscores,
apostrophes, punctuation; empty and missing values), a Text `u` (a reply:
sometimes `t` itself or a phrase of it), a PickList-like Text `c` with
tied frequencies, two Reals and a label. Terms tie in document frequency
on purpose: the count vectorizers' vocabulary order is held to the JAX
package's among ties too.
"""
import collections

import numpy as np

WORDS = ["invoice", "refund", "password", "login", "shipping", "delay",
         "broken", "screen", "battery", "charger", "upgrade", "plan",
         "account", "locked", "order", "missing", "package", "router",
         "signal", "reset", "can't", "won't", "error_code", "o'clock"]
ENTITIES = ["Maria Garcia", "Dr Smith", "Acme Corp", "Globex Inc",
            "Paris", "Tokyo", "Berlin", "on 2021-03-04", "$1,200.50",
            "12%", "at 9:30am", "Mr Jones", "John", "in Japan"]
FOREIGN = ["Der Router ist nicht mit dem Netz verbunden und die Rechnung "
           "über das Konto fehlt",
           "Le colis est arrivé mais la facture pour le compte est "
           "fausse et très chère",
           "El paquete no ha llegado y la contraseña de la cuenta es "
           "incorrecta",
           "Мой пароль не работает после обновления",
           "パスワードをリセットできません"]
CATEGORIES = ["red", "blue", "green", "teal", "", None]


def text_records(n=240, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        u = rng.uniform(size=6)
        words = list(rng.choice(WORDS, size=int(rng.integers(2, 14))))
        if u[0] < 0.5:
            words.insert(int(rng.integers(0, len(words) + 1)),
                         str(rng.choice(ENTITIES)))
        t = (None if u[1] < 0.05 else "" if u[1] < 0.08 else
             str(rng.choice(FOREIGN)) if u[1] < 0.2 else
             " ".join(words) + str(rng.choice([".", "!", "", "?"])))
        if u[2] < 0.1:
            reply = t
        elif u[2] < 0.2 and t:
            reply = " ".join(t.split()[:2])
        elif u[2] < 0.25:
            reply = None
        else:
            reply = " ".join(rng.choice(WORDS, size=int(rng.integers(1, 8))))
        out.append({
            "t": t, "u": reply,
            "c": CATEGORIES[int(rng.integers(0, len(CATEGORIES)))],
            "x": float(rng.normal()),
            "label": float(("refund" in words) ^ (u[3] < 0.2))})
    return out


def category_labels(records):
    """The indexer's labels of `c` as OpStringIndexer fits them (frequency
    order, ties in first-seen order), for `deindexed`."""
    return [w for w, _ in collections.Counter(
        r["c"] for r in records
        if r["c"] is not None and r["c"] != "").most_common()]


def text_stages(FB, records):
    """(dsl name, feature) of each text dsl name of the JAX package that
    the port ported last, built through the dsl on `text_records`'
    features."""
    t, u = FB.Text("t").as_predictor(), FB.Text("u").as_predictor()
    c = FB.Text("c").as_predictor()
    toks, utoks = t.tokenize(), u.tokenize()
    counts = toks.count_vectorize(vocab_size=24)
    index = c.index_string()
    return [
        ("text_len", t.text_len()),
        ("detect_languages", t.detect_languages()),
        ("index_string", index),
        ("count_vectorize", counts),
        ("tf_idf", toks.tf_idf(vocab_size=20)),
        ("lda", counts.lda(k=3, max_iter=20, seed=3)),
        ("word2vec", toks.word2vec(vector_size=6, vocab_bins=64, seed=2)),
        ("recognize_entities", t.recognize_entities()),
        ("ngram_similarity", toks.ngram_similarity(utoks)),
        ("jaccard_similarity", t.to_multi_pick_list().jaccard_similarity(
            u.to_multi_pick_list())),
        ("to_multi_pick_list", c.to_multi_pick_list()),
        ("is_substring", u.is_substring(t)),
        ("tokenize_regex", t.tokenize_regex(pattern=r"[a-z']+")),
        ("remove_stop_words", toks.remove_stop_words()),
        ("ngram", toks.ngram(3)),
        ("deindexed", index.deindexed(category_labels(records))),
        ("idf", counts.idf(min_doc_freq=2)),
    ]
