"""Workflow-model persistence: one JSON graph + one npz array store
(counterpart of workflow/io.py, in its format).

Reference: core/.../OpWorkflowModelWriter.scala:52 (single ``op-model.json``
with uids, features JSON, stages JSON, params) and OpWorkflowModelReader.scala
:51. Each stage's `save_args()` goes into the JSON with its arrays hoisted
into ``arrays.npz`` (stages/registry.pack_args); loading rebuilds every stage
through the registry and re-wires the feature lineage graph. The keys, class
names, uids and layers are the JAX package's, so a model saved by either
package loads in the other. `load_model(path, device=...)` places every
fitted stage on that device (None: CUDA, as at every entry point) and
remembers the directory as `model.source_path`.

The serving manifest (serve.json) records what `serve --prewarm-only`
prewarmed beside the model, stamped with the model's content hash so a
later start can tell whether it still describes this artifact. The drift
monitor's reference profile (monitor.json) is the JAX package's
(monitor/, not ported): the port writes none, and reads one only to
stamp and verify the manifest as the JAX package does.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional

import numpy as np

from ..data.vector import VectorMetadata
from ..device import DeviceLike
from ..features.feature import Feature
from ..features.generator import FeatureGeneratorStage
from ..stages.base import PipelineStage
from ..stages.registry import build_stage, pack_args, unpack_args
from ..types import FeatureType
from .dag import StagesDAG, collect_features
from .fitting import LayerRunner
from .workflow import WorkflowModel

MODEL_JSON = "op-model.json"
ARRAYS_NPZ = "arrays.npz"
SERVE_JSON = "serve.json"
MONITOR_JSON = "monitor.json"
FORMAT_VERSION = 1


def save_model(model: WorkflowModel, path: str, overwrite: bool = True) -> None:
    """Write `model` to the directory `path` (replaced when `overwrite`)."""
    if os.path.exists(path):
        if not overwrite:
            raise FileExistsError(path)
        if os.path.isdir(path):
            shutil.rmtree(path)
        else:
            os.remove(path)
    os.makedirs(path, exist_ok=True)

    store: Dict[str, np.ndarray] = {}
    features = collect_features(model.result_features)

    feat_json: List[Dict[str, Any]] = []
    gen_stages: Dict[str, FeatureGeneratorStage] = {}
    for f in features:
        feat_json.append({
            "uid": f.uid,
            "name": f.name,
            "type": f.feature_type.type_name(),
            "is_response": f.is_response,
            "origin_stage_uid": f.origin_stage.uid if f.origin_stage else None,
            "parent_uids": [p.uid for p in f.parents],
        })
        if isinstance(f.origin_stage, FeatureGeneratorStage):
            gen_stages[f.origin_stage.uid] = f.origin_stage

    gen_json = [
        {"class": type(g).__name__, "args": pack_args(g.save_args(), store, g.uid)}
        for g in gen_stages.values()
    ]

    layers_json: List[List[Dict[str, Any]]] = []
    for layer in model.dag.layers:
        lj: List[Dict[str, Any]] = []
        for st in layer:
            entry = {
                "class": type(st).__name__,
                "uid": st.uid,
                "args": pack_args(st.save_args(), store, st.uid),
                "input_uids": [f.uid for f in st.input_features],
                "output_name": st.output_name(),
            }
            md = getattr(st, "output_metadata", lambda: None)()
            if isinstance(md, VectorMetadata):
                entry["metadata"] = md.to_json()
            lj.append(entry)
        layers_json.append(lj)

    from .. import __version__
    doc = {
        "format_version": FORMAT_VERSION,
        # which framework build trained this artifact
        "framework_version": __version__,
        "result_feature_uids": [f.uid for f in model.result_features],
        "blacklisted_features": model.blacklist,
        "features": feat_json,
        "generators": gen_json,
        "stage_layers": layers_json,
        "raw_feature_filter": (model.rff_results.to_json()
                               if model.rff_results is not None else None),
    }
    with open(os.path.join(path, MODEL_JSON), "w") as fh:
        json.dump(doc, fh, indent=1)
    np.savez_compressed(os.path.join(path, ARRAYS_NPZ), **store)


def load_model(path: str,
               custom_stages: Optional[Dict[str, PipelineStage]] = None,
               device: DeviceLike = None) -> WorkflowModel:
    """The model saved in the directory `path` by either package, every
    stage on `device`. `custom_stages` maps a stage uid to the stage to use
    in its place (lambda stages, whose function does not travel)."""
    with open(os.path.join(path, MODEL_JSON)) as fh:
        doc = json.load(fh)
    if doc.get("format_version", 0) > FORMAT_VERSION:
        raise ValueError(f"Model format {doc['format_version']} is newer than "
                         f"this library supports ({FORMAT_VERSION})")
    npz_path = os.path.join(path, ARRAYS_NPZ)
    store: Dict[str, np.ndarray] = {}
    if os.path.exists(npz_path):
        with np.load(npz_path, allow_pickle=False) as z:
            store = {k: z[k] for k in z.files}
    custom_stages = custom_stages or {}

    # 1. rebuild stages
    stages: Dict[str, PipelineStage] = {}
    for gj in doc["generators"]:
        args = unpack_args(gj["args"], store)
        st = custom_stages.get(args.get("uid")) \
            or build_stage(gj["class"], args)
        stages[st.uid] = st
    layer_entries: List[List[Dict[str, Any]]] = doc["stage_layers"]
    for layer in layer_entries:
        for ej in layer:
            if ej["uid"] in custom_stages:
                st = custom_stages[ej["uid"]]
                if st.device is None:
                    st.device = device
            else:
                args = unpack_args(ej["args"], store)
                if args.get("lambda"):
                    raise ValueError(
                        f"stage {ej['class']} (uid {ej['uid']}) holds a "
                        "function that was not saved: pass the stage in "
                        "custom_stages={uid: stage}")
                st = build_stage(ej["class"], args, device=device)
            stages[ej["uid"]] = st

    # 2. rebuild the feature graph (parents before children by construction)
    feats: Dict[str, Feature] = {}
    for fj in doc["features"]:
        origin = stages.get(fj["origin_stage_uid"]) \
            if fj["origin_stage_uid"] else None
        f = Feature(
            name=fj["name"],
            feature_type=FeatureType.from_name(fj["type"]),
            is_response=fj["is_response"],
            origin_stage=origin,
            parents=[feats[p] for p in fj["parent_uids"]],
            uid=fj["uid"],
        )
        feats[f.uid] = f

    # 3. wire stage inputs / outputs
    for layer in layer_entries:
        for ej in layer:
            st = stages[ej["uid"]]
            st.set_input(*[feats[u] for u in ej["input_uids"]])
            st.set_output_name(ej["output_name"])
            if ej.get("metadata") and hasattr(st, "set_metadata"):
                st.set_metadata(VectorMetadata.from_json(ej["metadata"]))

    dag = StagesDAG(layers=[[stages[ej["uid"]] for ej in layer]
                            for layer in layer_entries])

    rff = None
    if doc.get("raw_feature_filter"):
        from ..filters.raw_feature_filter import RawFeatureFilterResults
        rff = RawFeatureFilterResults.from_json(doc["raw_feature_filter"])

    model = WorkflowModel(
        result_features=[feats[u] for u in doc["result_feature_uids"]],
        dag=dag, runner=LayerRunner(device),
        blacklist=doc.get("blacklisted_features", []),
        rff_results=rff,
    )
    # where the artifact lives: the serving engine reads the prewarm
    # manifest (serve.json) beside it
    model.source_path = path
    return model


# -- serving prewarm manifest -------------------------------------------------
# `serve --prewarm-only` records the bucket ladder and template record it
# prewarmed beside the model; a later `serve <dir>` prewarms the same
# ladder. The manifest stamps the model's content hash and whether a
# monitor profile existed at prewarm time, and adoption verifies both: a
# model re-saved after the prewarm no longer matches what was prewarmed.

def model_content_hash(model_dir: Optional[str]) -> Optional[str]:
    """Content hash of the model artifact (op-model.json + arrays.npz), 16
    hex chars: the identity serve.json stamps at --prewarm-only time and
    every adoption re-computes. None when there is no artifact."""
    import hashlib

    if not model_dir or not os.path.exists(os.path.join(model_dir,
                                                        MODEL_JSON)):
        return None
    h = hashlib.sha256()
    for fname in (MODEL_JSON, ARRAYS_NPZ):
        p = os.path.join(model_dir, fname)
        h.update(fname.encode())
        if not os.path.exists(p):
            h.update(b"|absent")
            continue
        with open(p, "rb") as fh:
            for chunk in iter(lambda: fh.read(1 << 20), b""):
                h.update(chunk)
    return h.hexdigest()[:16]


def manifest_stamp(model_dir: Optional[str]) -> Dict[str, Any]:
    """The freshness fields `serve --prewarm-only` stamps into serve.json:
    the model content hash and whether a monitor.json reference profile was
    present when the ladder was prewarmed."""
    return {
        "model_hash": model_content_hash(model_dir),
        "monitor_profile": bool(
            model_dir
            and os.path.exists(os.path.join(model_dir, MONITOR_JSON))),
    }


def verify_serve_manifest(model_dir: Optional[str],
                          manifest: Optional[Dict[str, Any]]
                          ) -> List[str]:
    """Mismatch strings for a manifest adopted against the artifact as it
    is now; an empty list means fresh (a manifest without the stamp
    verifies vacuously). The serving engine warns on any mismatch and
    `serve --strict-manifest` refuses to start on it (rc 2)."""
    problems: List[str] = []
    if not manifest or not model_dir:
        return problems
    stamped = manifest.get("model_hash")
    if stamped is not None:
        now = model_content_hash(model_dir)
        if now != stamped:
            problems.append(
                f"model_hash {now} != manifest {stamped} (model re-saved "
                f"after `serve --prewarm-only`; prewarm will miss the "
                f"persistent cache)")
    if "monitor_profile" in manifest:
        has_prof = os.path.exists(os.path.join(model_dir, MONITOR_JSON))
        if bool(manifest["monitor_profile"]) != has_prof:
            problems.append(
                f"monitor.json {'appeared' if has_prof else 'vanished'} "
                f"since the manifest was written (monitor_profile="
                f"{manifest['monitor_profile']})")
    return problems


def save_serve_manifest(model_dir: str, manifest: Dict[str, Any]) -> str:
    p = os.path.join(model_dir, SERVE_JSON)
    with open(p, "w") as fh:
        json.dump(manifest, fh, indent=1, default=str)
    return p


def load_serve_manifest(model_dir: Optional[str]) -> Optional[Dict[str, Any]]:
    if not model_dir:
        return None
    p = os.path.join(model_dir, SERVE_JSON)
    if not os.path.exists(p):
        return None
    try:
        with open(p) as fh:
            doc = json.load(fh)
        return doc if isinstance(doc, dict) else None
    except (OSError, json.JSONDecodeError):
        return None  # a corrupt manifest must not block serving startup


def load_monitor_profile(model_dir: Optional[str]
                         ) -> Optional[Dict[str, Any]]:
    """The JAX package's drift-monitor reference profile beside a model
    (monitor.json), or None when absent or unreadable. The port has no
    drift monitor: `serve` reads this only to say that it serves such a
    model unmonitored."""
    if not model_dir:
        return None
    p = os.path.join(model_dir, MONITOR_JSON)
    if not os.path.exists(p):
        return None
    try:
        with open(p) as fh:
            doc = json.load(fh)
        return doc if isinstance(doc, dict) and doc.get("features") \
            is not None else None
    except (OSError, json.JSONDecodeError):
        return None
