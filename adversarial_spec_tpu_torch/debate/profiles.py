"""Profiles and global config.

The PyTorch port's copy of ``adversarial_spec_tpu/debate/profiles.py``.

Behavioral parity with reference scripts/providers.py:88-244:
- Named profiles persist a bundle of debate settings; loading a profile only
  fills arguments the user did not set explicitly on the command line
  (flag > profile precedence, reference debate.py:529-550).
- A global config JSON holds cross-run settings; in the reference this is
  the Bedrock gateway section, here it is the default mesh/dtype and the
  model-registry location for the ``tpu://`` provider.

Module-level path constants for test patchability (SURVEY §4).
"""

from __future__ import annotations

import json
from pathlib import Path

from adversarial_spec_tpu_torch.obs.events import atomic_write_text

PROFILES_DIR = Path.home() / ".config" / "adversarial-spec-tpu" / "profiles"
GLOBAL_CONFIG_PATH = (
    Path.home() / ".config" / "adversarial-spec-tpu" / "config.json"
)

# Settings a profile may carry. Mirrors the reference's profile surface
# (models/doc-type/focus/persona/preserve-intent/timeout) plus TPU-native
# decode fields. Mesh/dtype live in the model registry, not profiles.
PROFILE_FIELDS = (
    "models",
    "doc_type",
    "focus",
    "persona",
    "preserve_intent",
    "timeout",
    "max_new_tokens",
    "temperature",
)


def save_profile(
    name: str, settings: dict, profiles_dir: Path | None = None
) -> Path:
    directory = Path(profiles_dir or PROFILES_DIR)
    directory.mkdir(parents=True, exist_ok=True)
    unknown = set(settings) - set(PROFILE_FIELDS)
    if unknown:
        raise ValueError(f"unknown profile fields: {sorted(unknown)}")
    path = directory / f"{name}.json"
    # tmp+replace (GL-ATOMIC): a crash mid-save must not tear a profile
    # a later run then half-loads.
    atomic_write_text(str(path), json.dumps(settings, indent=2))
    return path


def load_profile(name: str, profiles_dir: Path | None = None) -> dict:
    directory = Path(profiles_dir or PROFILES_DIR)
    path = directory / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"profile {name!r} not found at {path}")
    data = json.loads(path.read_text())
    return {k: v for k, v in data.items() if k in PROFILE_FIELDS}


def list_profiles(profiles_dir: Path | None = None) -> dict[str, dict]:
    directory = Path(profiles_dir or PROFILES_DIR)
    if not directory.is_dir():
        return {}
    out: dict[str, dict] = {}
    for path in sorted(directory.glob("*.json")):
        try:
            out[path.stem] = json.loads(path.read_text())
        except (json.JSONDecodeError, OSError):
            continue
    return out


def apply_profile(args, profile: dict) -> list[str]:
    """Fill unset argparse fields from a profile; explicit flags win.

    Returns the list of field names the profile actually supplied, for
    user-facing reporting. Parity: reference debate.py:538-550 — only
    ``None``/falsy (never-set) argument slots are filled.
    """
    applied = []
    for key, value in profile.items():
        if key not in PROFILE_FIELDS:
            continue
        current = getattr(args, key, None)
        # Identity checks: 0 / 0.0 are real user choices (0 == False would
        # make `--temperature 0` profile-overridable).
        unset = (
            current is None
            or current is False
            or (isinstance(current, list) and not current)
        )
        if unset:
            setattr(args, key, value)
            applied.append(key)
    return applied


def load_global_config(config_path: Path | None = None) -> dict:
    path = Path(config_path or GLOBAL_CONFIG_PATH)
    if not path.is_file():
        return {}
    try:
        return json.loads(path.read_text())
    except (json.JSONDecodeError, OSError):
        return {}


def save_global_config(config: dict, config_path: Path | None = None) -> Path:
    path = Path(config_path or GLOBAL_CONFIG_PATH)
    path.parent.mkdir(parents=True, exist_ok=True)
    # tmp+replace (GL-ATOMIC): same torn-state discipline as profiles.
    atomic_write_text(str(path), json.dumps(config, indent=2))
    return path
