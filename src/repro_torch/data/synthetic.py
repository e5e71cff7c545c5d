"""Synthetic multimodal dataset with Modality Composition Incoherence
(a copy of ``repro.data.synthetic``).

The paper (S3.1, Fig. 3) characterizes production MLLM instruction-tuning
data: the proportion of each modality's subsequence within the full
interleaved sequence varies dramatically across examples because the
dataset mixes tasks.  We reproduce that structure with a task mixture:

  asr       audio long, text ~ proportional to audio (positive corr)
  sqa       audio long, text short & UNcorrelated ('yes/no answers')
  caption   image medium, text short
  vqa       image large (anyres: 1-5 tiles), text medium
  text      text only, heavy-tailed lengths
  doc       image very large (many tiles), text long

Every example carries per-modality metadata token counts plus the
interleave order, which is exactly the structure the MLLM Global
Orchestrator gathers (paper S7: 'a structure to record ... the counts of
subsequences of different modalities and the order in which the
subsequences are interleaved').
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = ["Example", "TaskMix", "sample_examples"]


@dataclasses.dataclass
class Example:
    """One multimodal example.  Subsequence lengths are in LLM tokens
    (post-connector, post-downsample); metadata lengths are in encoder
    tokens (pre-downsample)."""

    task: str
    text_len: int
    # per modality: encoder-input token count (0 = absent).
    vision_meta: int
    audio_meta: int
    # interleave order, e.g. ("vision", "text") or ("text", "audio", "text").
    order: tuple[str, ...]

    def subseq_len(self, modality: str, downsample: dict[str, int]) -> int:
        if modality == "text":
            return self.text_len
        meta = self.vision_meta if modality == "vision" else self.audio_meta
        ds = downsample.get(modality, 1)
        return int(np.ceil(meta / ds)) if meta else 0

    def total_len(self, downsample: dict[str, int]) -> int:
        return (
            self.text_len
            + self.subseq_len("vision", downsample)
            + self.subseq_len("audio", downsample)
        )


@dataclasses.dataclass(frozen=True)
class TaskMix:
    """Mixture weights; defaults roughly mimic an omni instruction mix."""

    asr: float = 0.2
    sqa: float = 0.15
    caption: float = 0.2
    vqa: float = 0.2
    text: float = 0.15
    doc: float = 0.1

    def names_probs(self):
        d = dataclasses.asdict(self)
        names = list(d)
        p = np.array([d[k] for k in names])
        return names, p / p.sum()


def _lognormal_int(rng, mean, sigma, lo, hi):
    return int(np.clip(rng.lognormal(np.log(mean), sigma), lo, hi))


def _sample_one(rng: np.random.Generator, task: str) -> Example:
    if task == "asr":
        audio = _lognormal_int(rng, 600, 0.6, 50, 1500)
        text = max(8, int(audio * rng.normal(0.25, 0.04)))  # corr w/ audio
        return Example(task, text, 0, audio, ("audio", "text"))
    if task == "sqa":
        audio = _lognormal_int(rng, 700, 0.7, 50, 1500)
        text = _lognormal_int(rng, 30, 0.9, 2, 300)  # uncorrelated
        return Example(task, text, 0, audio, ("audio", "text"))
    if task == "caption":
        vision = int(rng.choice([256, 576, 1024]))
        text = _lognormal_int(rng, 60, 0.7, 8, 400)
        return Example(task, text, vision, 0, ("vision", "text"))
    if task == "vqa":
        tiles = int(rng.integers(1, 6))  # anyres 1-5 tiles
        vision = tiles * 576
        text = _lognormal_int(rng, 150, 0.8, 16, 1200)
        return Example(task, text, vision, 0, ("vision", "text"))
    if task == "doc":
        tiles = int(rng.integers(4, 9))
        vision = tiles * 576
        text = _lognormal_int(rng, 700, 0.6, 64, 4000)
        return Example(task, text, vision, 0, ("text", "vision", "text"))
    # plain text, heavy-tailed
    text = _lognormal_int(rng, 400, 1.1, 10, 16384)
    return Example(task, text, 0, 0, ("text",))


def sample_examples(
    rng: np.random.Generator, n: int, mix: TaskMix | None = None,
    modalities: Sequence[str] = ("vision", "audio"),
) -> list[Example]:
    """Random i.i.d. sampling -- preserves batching randomness (S2.3)."""
    mix = mix or TaskMix()
    names, probs = mix.names_probs()
    out = []
    while len(out) < n:
        task = names[int(rng.choice(len(names), p=probs))]
        ex = _sample_one(rng, task)
        if "vision" not in modalities and ex.vision_meta:
            continue
        if "audio" not in modalities and ex.audio_meta:
            continue
        out.append(ex)
    return out
