"""User and experiment-sharing records.

Counterpart: ``tmlibrary_tpu/models/user.py`` (reference
``tmlib/models/user.py`` ``User`` and the ``ExperimentShare``
association of ``tmlib/models/experiment.py``), which imports no JAX;
the port keeps its own copy.  The records live in a JSON registry file
(``users.json`` next to the experiment stores) holding ownership and
read/write grants, written with the reference's bytes (``json.dumps``
with ``indent=2``), so either package reads the other's file.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path


@dataclasses.dataclass
class User:
    """A user (the reference's ``User`` without password auth, which
    belongs to a serving layer, not the compute library)."""

    name: str
    email: str = ""


@dataclasses.dataclass
class ExperimentShare:
    """A grant of access to one experiment."""

    experiment: str
    user: str
    write: bool = False


class UserRegistry:
    """JSON-file registry of users, experiment ownership and shares."""

    def __init__(self, path: Path):
        self.path = Path(path)
        self._data = {"users": {}, "owners": {}, "shares": []}
        if self.path.exists():
            self._data = json.loads(self.path.read_text())

    def _save(self) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.path.write_text(json.dumps(self._data, indent=2))

    def add_user(self, user: User) -> None:
        self._data["users"][user.name] = {"email": user.email}
        self._save()

    def users(self) -> list[User]:
        return [User(n, d.get("email", "")) for n, d in sorted(self._data["users"].items())]

    def set_owner(self, experiment: str, user: str) -> None:
        if user not in self._data["users"]:
            raise KeyError(f"unknown user '{user}'")
        self._data["owners"][experiment] = user
        self._save()

    def share(self, share: ExperimentShare) -> None:
        if share.user not in self._data["users"]:
            raise KeyError(f"unknown user '{share.user}'")
        self._data["shares"].append(dataclasses.asdict(share))
        self._save()

    def can_read(self, experiment: str, user: str) -> bool:
        if self._data["owners"].get(experiment) == user:
            return True
        return any(s["experiment"] == experiment and s["user"] == user
                   for s in self._data["shares"])

    def can_write(self, experiment: str, user: str) -> bool:
        if self._data["owners"].get(experiment) == user:
            return True
        return any(s["experiment"] == experiment and s["user"] == user and s["write"]
                   for s in self._data["shares"])
