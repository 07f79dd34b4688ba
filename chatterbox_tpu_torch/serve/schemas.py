"""REST request and response schemas: the fields, defaults and ranges of the
JAX package's ``serve/schemas.py`` (text 1-5000 characters, cfg_weight 0-1,
temperature 0.1-2, quality default or turbo, ...), as dataclasses with
their own validation, so that the port needs no pydantic.

``Schema.parse(dict)`` takes a JSON object, ignores keys it does not know
and raises ``ValidationError`` (a ``ValueError``, as pydantic's is) for a
missing required field, a value of the wrong type or one out of range; the
server answers it with 422. Construction validates the same way, and
``model_dump()`` returns the fields as a dict.
"""

import copy
import dataclasses
import json
import re
import time
import typing
from dataclasses import dataclass, field
from typing import Dict, List, Optional

_REQUIRED = dataclasses.MISSING


class ValidationError(ValueError):
    """One or more fields failed validation; ``errors()`` lists them as
    {"loc": [field], "msg": text, "input": value}."""

    def __init__(self, errors: List[dict]):
        self._errors = errors
        super().__init__("; ".join(f"{e['loc'][0]}: {e['msg']}" for e in errors))

    def errors(self) -> List[dict]:
        return list(self._errors)

    def json(self) -> str:
        return json.dumps(self._errors, default=repr)


def F(default=_REQUIRED, *, default_factory=None, **limits):
    """A field with range limits: ``ge``/``le`` (numbers), ``min_length``/
    ``max_length`` (strings) and ``pattern`` (a full-match regex)."""
    if default_factory is not None:
        return field(default_factory=default_factory, metadata=limits)
    return field(default=default, metadata=limits)


_TRUE = {"1", "true", "yes", "on"}
_FALSE = {"0", "false", "no", "off"}


def _coerce(tp, v):
    """``v`` as the annotated type ``tp``, converting what pydantic's lax
    mode converts (numeric strings, integral floats, "true"/"0" for bools,
    a comma-separated string for a tuple); else ValueError."""
    origin = typing.get_origin(tp)
    if origin is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if v is None:
            return None
        return _coerce(args[0], v)
    if tp is bool:
        if isinstance(v, bool):
            return v
        if isinstance(v, int) and v in (0, 1):
            return bool(v)
        if isinstance(v, str) and v.lower() in _TRUE | _FALSE:
            return v.lower() in _TRUE
        raise ValueError("a boolean is required")
    if tp is int:
        if isinstance(v, bool):
            raise ValueError("an integer is required")
        if isinstance(v, int):
            return v
        if isinstance(v, float) and v.is_integer():
            return int(v)
        if isinstance(v, str):
            try:
                return int(v.strip())
            except ValueError:
                pass
        raise ValueError("an integer is required")
    if tp is float:
        if isinstance(v, bool):
            raise ValueError("a number is required")
        if isinstance(v, (int, float)):
            return float(v)
        if isinstance(v, str):
            try:
                return float(v.strip())
            except ValueError:
                pass
        raise ValueError("a number is required")
    if tp is str:
        if isinstance(v, str):
            return v
        raise ValueError("a string is required")
    if tp is tuple:
        if isinstance(v, str):
            return tuple(s.strip() for s in v.split(",") if s.strip())
        if isinstance(v, (list, tuple)):
            return tuple(v)
        raise ValueError("a list is required")
    if origin in (list, List):
        (item,) = typing.get_args(tp) or (str,)
        if not isinstance(v, (list, tuple)):
            raise ValueError("a list is required")
        return [_coerce(item, x) for x in v]
    if origin in (dict, Dict) or tp is dict:
        if not isinstance(v, dict):
            raise ValueError("an object is required")
        return v
    raise TypeError(f"no coercion for {tp}")


def _check(limits: dict, v):
    if v is None:
        return
    if "ge" in limits and v < limits["ge"]:
        raise ValueError(f"must be >= {limits['ge']}")
    if "le" in limits and v > limits["le"]:
        raise ValueError(f"must be <= {limits['le']}")
    if "min_length" in limits and len(v) < limits["min_length"]:
        raise ValueError(f"must have at least {limits['min_length']} characters")
    if "max_length" in limits and len(v) > limits["max_length"]:
        raise ValueError(f"must have at most {limits['max_length']} characters")
    if "pattern" in limits and not re.fullmatch(limits["pattern"], v):
        raise ValueError(f"must match {limits['pattern']}")


class Schema:
    """Validation, ``parse``, ``model_dump`` and ``model_copy`` for the
    dataclasses below."""

    def __post_init__(self):
        hints = typing.get_type_hints(type(self))
        errors = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            try:
                v = _coerce(hints[f.name], v)
                _check(f.metadata, v)
            except ValueError as e:
                errors.append({"loc": [f.name], "msg": str(e), "input": v})
                continue
            object.__setattr__(self, f.name, v)
        if errors:
            raise ValidationError(errors)

    @classmethod
    def parse(cls, data) -> "Schema":
        """A JSON object -> an instance; unknown keys are ignored."""
        if not isinstance(data, dict):
            raise ValidationError([{"loc": ["body"], "msg": "a JSON object is required",
                                    "input": data}])
        names = {f.name: f for f in dataclasses.fields(cls)}
        missing = [n for n, f in names.items()
                   if f.default is _REQUIRED and f.default_factory is _REQUIRED and n not in data]
        if missing:
            raise ValidationError([{"loc": [n], "msg": "field required", "input": None}
                                   for n in missing])
        return cls(**{k: v for k, v in data.items() if k in names})

    def model_dump(self) -> dict:
        return {f.name: copy.deepcopy(getattr(self, f.name)) for f in dataclasses.fields(self)}

    def model_copy(self, update: Optional[dict] = None) -> "Schema":
        return type(self)(**{**self.model_dump(), **(update or {})})


@dataclass
class TTSRequest(Schema):
    text: str = F(min_length=1, max_length=5000)
    emotion: Optional[str] = None
    # None: the emotion profile's stored exaggeration (or the server's
    # default without a profile); a value overrides it for the request
    exaggeration: Optional[float] = F(None, ge=0.0, le=2.0)
    cfg_weight: float = F(0.5, ge=0.0, le=1.0)
    temperature: float = F(0.8, ge=0.1, le=2.0)
    repetition_penalty: float = F(1.2, ge=1.0, le=3.0)
    min_p: float = F(0.05, ge=0.0, le=1.0)
    top_p: float = F(1.0, ge=0.0, le=1.0)
    seed: Optional[int] = None
    return_base64: bool = True
    max_new_tokens: int = F(1000, ge=1, le=1000)
    # the quality tier: "default" runs the config's CFM steps, "turbo" the
    # server's turbo_flow_steps
    quality: str = F("default", pattern="^(default|turbo)$")
    # the alignment watchdog in the T3 decode loop (not on /generate/stream)
    alignment: bool = False


@dataclass
class TTSResponse(Schema):
    success: bool = True
    audio_base64: Optional[str] = None
    audio_url: Optional[str] = None
    sample_rate: int = 24000
    duration_seconds: float = 0.0
    generation_time_seconds: float = 0.0
    rtf: float = 0.0  # generation_time / duration
    metadata: Dict = F(default_factory=dict)


@dataclass
class EmotionProfile(Schema):
    id: str = F()
    name: str = ""
    character: str = ""  # groups emotions by character
    description: str = ""
    exaggeration: float = F(0.5, ge=0.0, le=1.0)
    voice_samples: List[str] = F(default_factory=list)
    created_at: float = F(default_factory=time.time)
    updated_at: float = F(default_factory=time.time)


@dataclass
class EmotionCreateRequest(Schema):
    id: str = F()
    name: str = ""
    character: str = ""
    description: str = ""
    exaggeration: float = F(0.5, ge=0.0, le=1.0)
    voice_samples: List[str] = F(default_factory=list)


@dataclass
class EmotionUpdateRequest(Schema):
    """A partial update: None leaves a field as it is."""

    name: Optional[str] = F(None, min_length=1, max_length=100)
    character: Optional[str] = F(None, min_length=1, max_length=100)
    exaggeration: Optional[float] = F(None, ge=0.0, le=1.0)
    description: Optional[str] = F(None, max_length=500)


@dataclass
class EmotionListResponse(Schema):
    emotions: List[dict] = F(default_factory=list)
    total_count: int = 0
    characters: List[str] = F(default_factory=list)


@dataclass
class VoiceUploadResponse(Schema):
    success: bool = F()
    message: str = F()
    voice_id: Optional[str] = None
    file_path: Optional[str] = None


@dataclass
class ServerStatus(Schema):
    status: str = "ok"
    model_loaded: bool = False
    device: str = ""
    emotions_ready: List[str] = F(default_factory=list)
    uptime_seconds: float = 0.0
    memory: Dict = F(default_factory=dict)
    batching: Dict = F(default_factory=dict)  # the batchers' counters
    version: str = "0.1.0"
