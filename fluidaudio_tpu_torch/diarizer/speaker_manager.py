"""Online nearest-centroid speaker database.

Behavioral parity: reference `Diarizer/Clustering/SpeakerManager.swift`
(dual thresholds assign vs embedding-update `:25-43`, init modes `:62-126`,
assign/update/create `:135-180,432-491`, matching/predicates `:184-221`,
permanence `:223-245`, merge + mergeable-pair discovery `:250-330`,
removal incl. inactivity + predicates `:334-405`, upsert `:527-608`,
reset + permanent-flag reset `:610-635`) and
`Clustering/SpeakerTypes.swift` (EMA main embedding, raw-embedding FIFO).
"""

from __future__ import annotations

import time
from typing import Callable, Iterable

import numpy as np

from fluidaudio_tpu_torch.diarizer.types import (
    RawEmbedding,
    Speaker,
    cosine_distance,
    l2_normalize,
)
from fluidaudio_tpu_torch.utils.logging import get_logger

logger = get_logger("diarizer.speakers")

EMBEDDING_SIZE = 256


class SpeakerManager:
    def __init__(
        self,
        speaker_threshold: float = 0.65,
        embedding_threshold: float = 0.45,
        min_speech_duration: float = 1.0,
        min_embedding_update_duration: float = 2.0,
        embedding_size: int = EMBEDDING_SIZE,
    ):
        self.speaker_threshold = speaker_threshold
        self.embedding_threshold = embedding_threshold
        self.min_speech_duration = min_speech_duration
        self.min_embedding_update_duration = min_embedding_update_duration
        self.embedding_size = embedding_size
        self._db: dict[str, Speaker] = {}
        self._next_id = 1
        self._highest_id = 0

    # ------------------------------------------------------------- queries

    @property
    def speaker_count(self) -> int:
        return len(self._db)

    @property
    def speaker_ids(self) -> list[str]:
        return sorted(self._db)

    @property
    def permanent_speaker_ids(self) -> list[str]:
        return sorted(k for k, v in self._db.items() if v.is_permanent)

    def has_speaker(self, speaker_id: str) -> bool:
        return speaker_id in self._db

    def get_speaker(self, speaker_id: str) -> Speaker | None:
        return self._db.get(speaker_id)

    def get_all_speakers(self) -> dict[str, Speaker]:
        return dict(self._db)

    def get_speaker_list(self) -> list[Speaker]:
        return list(self._db.values())

    def _closest(self, embedding: np.ndarray) -> tuple[str | None, float]:
        best_id, best = None, float("inf")
        for sid, spk in self._db.items():
            d = cosine_distance(embedding, spk.current_embedding)
            if d < best:
                best, best_id = d, sid
        return best_id, best

    def find_speaker(
        self, embedding: np.ndarray, speaker_threshold: float | None = None
    ) -> tuple[str | None, float]:
        sid, dist = self._closest(embedding)
        thr = speaker_threshold if speaker_threshold is not None else self.speaker_threshold
        if sid is not None and dist <= thr:
            return sid, dist
        return None, float("inf")

    def find_matching_speakers(
        self, embedding: np.ndarray, speaker_threshold: float | None = None
    ) -> list[tuple[str, float]]:
        """All speakers within `speaker_threshold`, closest first (ref :198-212)."""
        thr = speaker_threshold if speaker_threshold is not None else self.speaker_threshold
        matches = [
            (sid, cosine_distance(embedding, spk.current_embedding))
            for sid, spk in self._db.items()
        ]
        matches = [(sid, d) for sid, d in matches if d <= thr]
        matches.sort(key=lambda m: m[1])
        return matches

    def find_speakers_where(self, predicate: Callable[[Speaker], bool]) -> list[str]:
        return [sid for sid, spk in self._db.items() if predicate(spk)]

    # ------------------------------------------------------------ mutation

    def assign_speaker(
        self,
        embedding: np.ndarray,
        speech_duration: float,
        confidence: float = 1.0,
        speaker_threshold: float | None = None,
        new_name: str | None = None,
    ) -> Speaker | None:
        embedding = np.asarray(embedding, np.float32).reshape(-1)
        if embedding.size != self.embedding_size:
            logger.error("invalid embedding size %d", embedding.size)
            return None
        norm = l2_normalize(embedding)
        thr = speaker_threshold if speaker_threshold is not None else self.speaker_threshold
        sid, dist = self._closest(norm)

        if sid is not None and dist < thr:
            spk = self._db[sid]
            if dist < self.embedding_threshold and float(np.sum(norm**2)) > 0.01:
                spk.update_main_embedding(speech_duration, norm, alpha=0.9)
            else:
                spk.duration += speech_duration
                spk.updated_at = time.time()
            return spk

        if speech_duration >= self.min_speech_duration:
            return self._create_speaker(norm, speech_duration, name=new_name)
        logger.debug("segment too short (%.2fs) to create a speaker", speech_duration)
        return None

    def _create_speaker(
        self,
        norm_embedding: np.ndarray,
        duration: float,
        name: str | None = None,
        is_permanent: bool = False,
    ) -> Speaker:
        sid = str(self._next_id)
        self._next_id += 1
        self._highest_id = max(self._highest_id, self._next_id - 1)
        spk = Speaker(
            id=sid,
            name=name or f"Speaker {sid}",
            current_embedding=norm_embedding,
            duration=duration,
            is_permanent=is_permanent,
        )
        spk.add_raw_embedding(RawEmbedding(norm_embedding))
        self._db[sid] = spk
        return spk

    def initialize_known_speakers(
        self,
        speakers: Iterable[Speaker],
        mode: str = "skip",
        preserve_if_permanent: bool = True,
    ) -> None:
        """mode: skip | overwrite | merge | reset (ref :62-126).

        `preserve_if_permanent` shields pre-existing permanent speakers from
        the reset wipe and from overwrite/merge conflicts.
        """
        if mode == "reset":
            self.reset(keep_if_permanent=preserve_if_permanent)
        max_numeric = 0
        for spk in speakers:
            if np.size(spk.current_embedding) != self.embedding_size:
                logger.warning("skipping %s: bad embedding size", spk.id)
                continue
            existing = self._db.get(spk.id)
            if existing is not None:
                protected = existing.is_permanent and preserve_if_permanent
                if mode in ("overwrite", "reset"):
                    if protected:
                        continue
                    self._db[spk.id] = spk
                elif mode == "merge":
                    if protected:
                        continue
                    existing.merge_with(spk, keep_name=spk.name)
                else:  # skip
                    continue
            else:
                self._db[spk.id] = spk
            if spk.id.isdigit():
                max_numeric = max(max_numeric, int(spk.id))
        # Reference recomputes the counter from the initialized set (:119-120).
        self._highest_id = max_numeric
        self._next_id = max_numeric + 1

    def merge_speaker(
        self,
        source_id: str,
        into_id: str,
        merged_name: str | None = None,
        stop_if_permanent: bool = True,
    ) -> bool:
        if source_id == into_id:
            return False
        src, dst = self._db.get(source_id), self._db.get(into_id)
        if src is None or dst is None or (stop_if_permanent and src.is_permanent):
            return False
        dst.merge_with(src, keep_name=merged_name)
        del self._db[source_id]
        return True

    def find_mergeable_pairs(
        self,
        speaker_threshold: float | None = None,
        exclude_if_both_permanent: bool = True,
    ) -> list[tuple[str, str]]:
        """(source, destination) pairs close enough to merge (ref :282-330).

        Destination prefers the first speaker unless it is the non-permanent
        one of a permanent/non-permanent pair.
        """
        thr = speaker_threshold if speaker_threshold is not None else self.speaker_threshold
        ids = list(self._db)
        pairs: list[tuple[str, str]] = []
        for i, id1 in enumerate(ids):
            s1 = self._db[id1]
            for id2 in ids[i + 1 :]:
                s2 = self._db[id2]
                if exclude_if_both_permanent and s1.is_permanent and s2.is_permanent:
                    continue
                if cosine_distance(s1.current_embedding, s2.current_embedding) >= thr:
                    continue
                if not s2.is_permanent:
                    pairs.append((id2, id1))
                else:
                    pairs.append((id1, id2))
        return pairs

    def make_speaker_permanent(self, speaker_id: str) -> None:
        if speaker_id in self._db:
            self._db[speaker_id].is_permanent = True

    def revoke_permanence(self, speaker_id: str) -> None:
        if speaker_id in self._db:
            self._db[speaker_id].is_permanent = False

    def reset_permanent_flags(self) -> None:
        for spk in self._db.values():
            spk.is_permanent = False

    def remove_speaker(self, speaker_id: str, keep_if_permanent: bool = True) -> None:
        spk = self._db.get(speaker_id)
        if spk is None or (spk.is_permanent and keep_if_permanent):
            return
        del self._db[speaker_id]

    def remove_speakers_inactive_since(
        self, timestamp: float, keep_if_permanent: bool = True
    ) -> None:
        """Remove speakers last updated before `timestamp` (ref :353-370)."""
        for sid in list(self._db):
            spk = self._db[sid]
            if spk.updated_at < timestamp and not (spk.is_permanent and keep_if_permanent):
                del self._db[sid]

    def remove_speakers_inactive_for(
        self, duration_inactive: float, keep_if_permanent: bool = True
    ) -> None:
        self.remove_speakers_inactive_since(
            time.time() - duration_inactive, keep_if_permanent=keep_if_permanent
        )

    def remove_speakers_where(
        self, predicate: Callable[[Speaker], bool], keep_if_permanent: bool = True
    ) -> None:
        for sid in list(self._db):
            spk = self._db[sid]
            if predicate(spk) and not (spk.is_permanent and keep_if_permanent):
                del self._db[sid]

    def upsert_speaker(
        self,
        speaker: Speaker | None = None,
        *,
        id: str | None = None,
        name: str | None = None,
        current_embedding: np.ndarray | None = None,
        duration: float = 0.0,
        raw_embeddings: list[RawEmbedding] | None = None,
        update_count: int = 1,
        created_at: float | None = None,
        updated_at: float | None = None,
        is_permanent: bool = False,
    ) -> None:
        """Update-if-exists / insert-if-new (ref :527-608).

        Updating replaces embedding/duration/raw/update_count and bumps
        `updated_at`, keeps the original `created_at`, and can only turn the
        permanent flag ON. Inserting tracks numeric IDs into the counter.
        """
        if speaker is not None:
            id = speaker.id
            name = speaker.name
            current_embedding = speaker.current_embedding
            duration = speaker.duration
            raw_embeddings = speaker.raw_embeddings
            update_count = speaker.update_count
            created_at = speaker.created_at
            updated_at = speaker.updated_at
            is_permanent = speaker.is_permanent
        if id is None or current_embedding is None:
            raise ValueError("upsert_speaker needs an id and an embedding")
        now = time.time()
        existing = self._db.get(id)
        if existing is not None:
            existing.current_embedding = np.asarray(current_embedding, np.float32)
            existing.duration = duration
            existing.raw_embeddings = list(raw_embeddings or [])
            existing.update_count = update_count
            existing.updated_at = updated_at if updated_at is not None else now
            if name is not None:
                existing.name = name
            if is_permanent:
                existing.is_permanent = True
        else:
            spk = Speaker(
                id=id,
                name=name or id,
                current_embedding=np.asarray(current_embedding, np.float32),
                duration=duration,
                is_permanent=is_permanent,
                created_at=created_at if created_at is not None else now,
                updated_at=updated_at if updated_at is not None else now,
            )
            spk.raw_embeddings = list(raw_embeddings or [])
            spk.update_count = update_count
            self._db[id] = spk
            if id.isdigit():
                self._highest_id = max(self._highest_id, int(id))
                self._next_id = max(self._next_id, int(id) + 1)

    def reset(self, keep_if_permanent: bool = False) -> None:
        if keep_if_permanent:
            self._db = {k: v for k, v in self._db.items() if v.is_permanent}
            max_numeric = max(
                (int(k) for k in self._db if k.isdigit()), default=0
            )
            self._highest_id = max_numeric
            self._next_id = max_numeric + 1
        else:
            self._db = {}
            self._next_id = 1
            self._highest_id = 0
