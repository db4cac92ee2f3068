# Port of codec_tcc_tpu/parallel/runner.py: the same code but for the
# `device` the runner hands to pipeline.encode_file.
"""Fault-tolerant batch jobs with per-item checkpointing and resume.

The runner processes a list of image files (DICOM or PNG/PIL), writes one
container per input plus a JSON manifest checkpoint after every item, and on
restart skips finished items (so a failed shard re-runs only its remainder).
Per-item failures are isolated and recorded, not fatal. Items encode on
``device`` (default ``"cuda"``).
"""

from __future__ import annotations

import json
import os
import time
import traceback
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

from ..config import EncodeConfig
from ..utils.logging import get_logger

logger = get_logger("runner")

_MANIFEST = "manifest.json"


@dataclass
class ItemResult:
    input: str
    output: str
    status: str                 # "done" | "failed"
    error: Optional[str] = None
    s: Optional[int] = None
    payload_bits: Optional[int] = None
    container_bytes: Optional[int] = None
    psnr: Optional[float] = None
    elapsed_s: Optional[float] = None


class BatchRunner:
    """Encode many images into containers, checkpointing after each item."""

    def __init__(self, output_dir: str, config: EncodeConfig = EncodeConfig(),
                 *, device="cuda"):
        self.output_dir = output_dir
        self.config = config
        self.device = device
        os.makedirs(output_dir, exist_ok=True)
        self.manifest_path = os.path.join(output_dir, _MANIFEST)
        self.results: Dict[str, ItemResult] = {}
        self._load_manifest()

    def _load_manifest(self) -> None:
        if os.path.exists(self.manifest_path):
            with open(self.manifest_path, encoding="utf-8") as f:
                data = json.load(f)
            for row in data.get("items", []):
                self.results[row["input"]] = ItemResult(**row)
            logger.info(
                "resumed manifest: %d items (%d done)",
                len(self.results),
                sum(1 for r in self.results.values() if r.status == "done"),
            )

    def _save_manifest(self) -> None:
        tmp = self.manifest_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(
                {"items": [vars(r) for r in self.results.values()]},
                f, indent=2, sort_keys=True,
            )
        os.replace(tmp, self.manifest_path)  # atomic checkpoint

    def run(
        self,
        inputs: Sequence[str],
        payload: Union[bytes, str],
        *,
        retry_failed: bool = True,
    ) -> List[ItemResult]:
        from .. import pipeline

        for path in inputs:
            prior = self.results.get(path)
            if prior is not None and prior.status == "done":
                continue  # resume: already finished
            if prior is not None and prior.status == "failed" and not retry_failed:
                continue

            out_path = os.path.join(
                self.output_dir,
                os.path.splitext(os.path.basename(path))[0] + ".stgc",
            )
            t0 = time.perf_counter()
            try:
                res = pipeline.encode_file(
                    path, payload, self.config, device=self.device
                )
                with open(out_path, "wb") as f:
                    f.write(res.container)
                self.results[path] = ItemResult(
                    input=path,
                    output=out_path,
                    status="done",
                    s=res.s,
                    payload_bits=int(res.meta.payload_bits),
                    container_bytes=len(res.container),
                    psnr=(res.metrics or {}).get("psnr"),
                    elapsed_s=round(time.perf_counter() - t0, 3),
                )
            except Exception as exc:  # isolate per-item failures
                logger.error("item failed: %s: %s", path, exc)
                self.results[path] = ItemResult(
                    input=path,
                    output=out_path,
                    status="failed",
                    error=f"{type(exc).__name__}: {exc}",
                    elapsed_s=round(time.perf_counter() - t0, 3),
                )
                logger.debug("%s", traceback.format_exc())
            self._save_manifest()  # checkpoint after every item
        return [self.results[p] for p in inputs if p in self.results]

    @property
    def pending(self) -> List[str]:
        return [p for p, r in self.results.items() if r.status != "done"]
