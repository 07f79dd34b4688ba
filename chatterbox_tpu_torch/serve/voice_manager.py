"""Emotion-profile registry with precomputed, disk-cached conditionals.

Port of the JAX package's ``serve/voice_manager.py``: profiles persisted as
JSON, each profile's Conditionals (``prepare_conditionals`` of its longest
sample) cached on disk as safetensors (``Conditionals.save``/``load``),
keyed by (id, exaggeration, samples hash). Conditionals are immutable
values returned to the caller, so switching voices shares no model state.
"""

import hashlib
import json
import logging
import re
import threading
from pathlib import Path
from typing import Dict, List, Optional

from ..pipeline.conditionals import Conditionals
from .schemas import EmotionProfile

logger = logging.getLogger(__name__)


class VoiceManager:
    def __init__(self, tts, voice_dir, config_dir, cache_dir):
        self.tts = tts
        self.voice_dir = Path(voice_dir)
        self.config_dir = Path(config_dir)
        self.cache_dir = Path(cache_dir)
        for d in (self.voice_dir, self.config_dir, self.cache_dir):
            d.mkdir(parents=True, exist_ok=True)
        self._profiles: Dict[str, EmotionProfile] = {}
        self._conds: Dict[str, Conditionals] = {}
        self._lock = threading.Lock()
        self._load_profiles()

    # ------------------------------------------------------------- profiles
    @property
    def _profiles_path(self) -> Path:
        return self.config_dir / "emotions.json"

    def _load_profiles(self):
        if self._profiles_path.exists():
            data = json.loads(self._profiles_path.read_text())
            for item in data.get("emotions", []):
                prof = EmotionProfile.parse(item)
                self._profiles[prof.id] = prof

    def _save_profiles(self):
        data = {"emotions": [p.model_dump() for p in self._profiles.values()]}
        self._profiles_path.write_text(json.dumps(data, indent=2))

    def list_profiles(self) -> List[EmotionProfile]:
        return list(self._profiles.values())

    def get_profile(self, emotion_id: str) -> Optional[EmotionProfile]:
        return self._profiles.get(emotion_id)

    _ID_RE = re.compile(r"^[A-Za-z0-9_\-]{1,64}$")

    def create_profile(self, profile: EmotionProfile) -> EmotionProfile:
        # the id becomes part of on-disk cache filenames and voice_samples
        # become path components under voice_dir: sanitize BOTH or an
        # unauthenticated client writes/reads outside the storage dirs
        if not self._ID_RE.fullmatch(profile.id):
            raise ValueError(
                "emotion id must match [A-Za-z0-9_-]{1,64}"
            )
        profile = profile.model_copy(
            update={"voice_samples": [Path(s).name for s in profile.voice_samples]}
        )
        with self._lock:
            self._profiles[profile.id] = profile
            self._save_profiles()
        return profile

    def delete_profile(self, emotion_id: str) -> bool:
        with self._lock:
            if emotion_id not in self._profiles:
                return False
            del self._profiles[emotion_id]
            self._conds.pop(emotion_id, None)
            self._save_profiles()
        return True

    def update_profile(self, emotion_id: str, updates: dict) -> Optional[EmotionProfile]:
        """Partial update (reference voice_manager update flow); invalidates
        cached conditionals when exaggeration changes."""
        import time

        with self._lock:
            prof = self._profiles.get(emotion_id)
            if prof is None:
                return None
            data = prof.model_dump()
            for k, v in updates.items():
                if v is not None and k in ("name", "character", "description", "exaggeration"):
                    data[k] = v
            data["updated_at"] = time.time()
            new = EmotionProfile(**data)
            self._profiles[emotion_id] = new
            if new.exaggeration != prof.exaggeration:
                self._conds.pop(emotion_id, None)
            self._save_profiles()
            return new

    def list_characters(self) -> List[str]:
        return sorted({p.character for p in self._profiles.values() if p.character})

    # ---------------------------------------------------------- voice samples
    def add_voice_sample(self, emotion_id: str, data: bytes, filename: str,
                         description: Optional[str] = None) -> Optional[dict]:
        """Store an uploaded sample and attach it to a profile (reference
        voice_manager add_voice_sample / server.py:376-440)."""
        import time
        import uuid

        with self._lock:
            prof = self._profiles.get(emotion_id)
            if prof is None:
                return None
            safe = Path(filename).name
            (self.voice_dir / safe).write_bytes(data)
            if safe not in prof.voice_samples:
                prof.voice_samples.append(safe)
            prof.updated_at = time.time()
            self._conds.pop(emotion_id, None)  # samples changed
            self._save_profiles()
            return {
                "voice_id": uuid.uuid4().hex[:12],
                "filename": safe,
                "file_path": str(self.voice_dir / safe),
                "description": description,
            }

    def remove_voice_sample(self, emotion_id: str, voice_filename: str) -> bool:
        """Detach a sample from a profile (reference server.py:442-469). The
        file itself stays on disk (it may be shared by other profiles)."""
        import time

        with self._lock:
            prof = self._profiles.get(emotion_id)
            if prof is None or Path(voice_filename).name not in prof.voice_samples:
                return False
            prof.voice_samples.remove(Path(voice_filename).name)
            prof.updated_at = time.time()
            self._conds.pop(emotion_id, None)
            self._save_profiles()
            return True

    # ---------------------------------------------------------- conditionals
    def _cache_key(self, prof: EmotionProfile) -> str:
        h = hashlib.sha1()
        for s in sorted(prof.voice_samples):
            h.update(s.encode())
            p = self.voice_dir / Path(s).name
            if p.exists():
                h.update(str(p.stat().st_size).encode())
        return f"{prof.id}_{prof.exaggeration}_{h.hexdigest()[:12]}"

    def is_ready(self, emotion_id: str) -> bool:
        return emotion_id in self._conds

    def get_conditionals(self, emotion_id: str) -> Optional[Conditionals]:
        """Load (computing + caching if needed) a profile's conditionals."""
        prof = self._profiles.get(emotion_id)
        if prof is None:
            return None
        with self._lock:
            if emotion_id in self._conds:
                return self._conds[emotion_id]
            cache_file = self.cache_dir / (self._cache_key(prof) + ".safetensors")
            if cache_file.exists():
                conds = Conditionals.load(cache_file).to(self.tts.device)
            else:
                if not prof.voice_samples:
                    return None
                # primary sample = the longest one (voice_manager.py:131-155)
                from ..pipeline.audio import load_wav

                primary, max_dur = None, -1.0
                for name in prof.voice_samples:
                    p = self.voice_dir / Path(name).name
                    if not p.exists():
                        continue
                    try:
                        wav = load_wav(p)
                        if len(wav) > max_dur:
                            max_dur, primary = len(wav), p
                    except Exception:
                        logger.warning("unreadable voice sample %s", p, exc_info=True)
                if primary is None:
                    return None
                conds = self.tts.prepare_conditionals(str(primary), prof.exaggeration)
                conds.save(cache_file)
            self._conds[emotion_id] = conds
            return conds

    def get_stats(self) -> dict:
        return {
            "profiles": len(self._profiles),
            "ready": sorted(self._conds.keys()),
            "cached_files": len(list(self.cache_dir.glob("*.safetensors"))),
        }
