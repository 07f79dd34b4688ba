"""Server startup script: seeds example emotion profiles, then serves (port
of the JAX package's ``serve/run.py``)."""

import logging

from .config import get_config
from .schemas import EmotionProfile
from .server import run_server
from .service import TTSService

logger = logging.getLogger(__name__)

EXAMPLE_PROFILES = [
    EmotionProfile(id="neutral", name="Neutral", character="Narrator",
                   description="Balanced narration", exaggeration=0.5),
    EmotionProfile(id="calm", name="Calm", character="Narrator",
                   description="Low-intensity delivery", exaggeration=0.3),
    EmotionProfile(id="excited", name="Excited", character="Narrator",
                   description="High-energy delivery", exaggeration=0.9),
    EmotionProfile(id="dramatic", name="Dramatic", character="Narrator",
                   description="Theatrical emphasis", exaggeration=1.0),
]


def seed_profiles(service: TTSService):
    existing = {p.id for p in service.voices.list_profiles()}
    for prof in EXAMPLE_PROFILES:
        if prof.id not in existing:
            service.voices.create_profile(prof)
            logger.info("seeded emotion profile %r", prof.id)


def main():
    logging.basicConfig(level=logging.INFO)
    cfg = get_config()
    service = TTSService(cfg)
    seed_profiles(service)
    run_server(cfg, service=service)


if __name__ == "__main__":
    main()
