"""Element database.

reference: `src/structures/element.rs` — `Elements` (`:20`) holds an
ordered map of `Element` (`:147`) entries {symbol, GSL query, mass, vdw,
expected min/max bonds}; the default database is the reference's
`src/config/elements.yaml` (embedded at compile time there,
`element.rs:37`; itself derived from Gromacs atommass.dat / vdwradii.dat
and VMD vdw tables), shipped here as `config/elements.json` so that it
loads with the standard library.  Earlier entries take guessing
priority.  User files (YAML, read with PyYAML when it is installed, or
JSON) merge over it (`Elements::update`, `element.rs:112`).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

from ..errors import ElementError

_DEFAULT_DB = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "config", "elements.json")

_ALLOWED_FIELDS = {"symbol", "query", "mass", "vdw", "expected_max_bonds", "expected_min_bonds"}


@dataclass
class Element:
    name: str
    symbol: str | None = None
    query: str | None = None
    select: object = None  # parsed AST
    mass: float | None = None
    vdw: float | None = None
    expected_max_bonds: int | None = None
    expected_min_bonds: int | None = None

    def update_from(self, other: "Element"):
        """Merge non-None fields of `other` into self (reference: element.rs:112+)."""
        for f in ("symbol", "query", "select", "mass", "vdw",
                  "expected_max_bonds", "expected_min_bonds"):
            v = getattr(other, f)
            if v is not None:
                setattr(self, f, v)


class Elements:
    """Ordered element table; earlier entries take guessing priority."""

    def __init__(self, elements: dict[str, Element] | None = None):
        self.elements: dict[str, Element] = elements or {}

    # ------------------------------------------------------------- loading
    @classmethod
    def default(cls) -> "Elements":
        return cls.from_file(_DEFAULT_DB)

    @classmethod
    def from_file(cls, path) -> "Elements":
        """Load an element table from a YAML file (the reference's format;
        needs PyYAML) or, for a `.json` path, a JSON file."""
        try:
            with open(path) as fh:
                text = fh.read()
        except OSError:
            raise ElementError(f"file '{path}' was not found", code="FileNotFound") from None
        if str(path).endswith(".json"):
            try:
                raw = json.loads(text)
            except ValueError as e:
                raise ElementError(f"could not parse '{path}': {e}",
                                   code="CouldNotParseYaml") from None
        else:
            yaml = _yaml()
            try:
                raw = yaml.safe_load(text)
            except yaml.YAMLError as e:
                raise ElementError(f"could not parse '{path}': {e}",
                                   code="CouldNotParseYaml") from None
        if raw is None:
            return cls({})
        if not isinstance(raw, dict):
            raise ElementError(f"invalid elements file '{path}'", code="CouldNotParseYaml")
        elements = {}
        for name, fields in raw.items():
            elements[str(name)] = _parse_element(str(name), fields or {})
        return cls(elements)

    def update(self, other: "Elements"):
        """Merge another table over this one (reference: Elements::update)."""
        for name, elem in other.elements.items():
            if name in self.elements:
                self.elements[name].update_from(elem)
            else:
                self.elements[name] = elem

    # ------------------------------------------------------------- queries
    def names(self) -> list[str]:
        return list(self.elements.keys())

    def get(self, name: str) -> Element | None:
        return self.elements.get(name)


def _yaml():
    """PyYAML, imported only where a user hands over a YAML file."""
    try:
        import yaml
    except ImportError:
        raise ElementError(
            "reading a YAML element file needs PyYAML (pip install pyyaml); "
            "a .json file loads without it", code="CouldNotParseYaml") from None
    return yaml


def _parse_element(name: str, fields: dict) -> Element:
    from ..select import parse_query
    from ..errors import SelectError

    if not isinstance(fields, dict):
        raise ElementError(f"invalid definition of element '{name}'", code="InvalidField")
    unknown = set(fields.keys()) - _ALLOWED_FIELDS
    if unknown:
        raise ElementError(
            f"unknown field(s) {sorted(unknown)} in element '{name}'", code="InvalidField"
        )
    e = Element(name=name)
    if "symbol" in fields:
        e.symbol = str(fields["symbol"])
    if "query" in fields and fields["query"] is not None:
        e.query = str(fields["query"])
        try:
            e.select = parse_query(e.query)
        except SelectError as err:
            raise ElementError(
                f"invalid query '{e.query}' of element '{name}': {err}", code="InvalidQuery"
            ) from None
    for f, code in (("mass", "InvalidMass"), ("vdw", "InvalidVdW")):
        if f in fields and fields[f] is not None:
            try:
                v = float(fields[f])
            except (TypeError, ValueError):
                raise ElementError(
                    f"invalid {f} of element '{name}': '{fields[f]}'", code=code
                ) from None
            if v < 0.0:
                raise ElementError(
                    f"invalid {f} of element '{name}': '{fields[f]}'", code=code
                )
            setattr(e, f, v)
    for f in ("expected_max_bonds", "expected_min_bonds"):
        if f in fields and fields[f] is not None:
            try:
                v = int(fields[f])
                if v < 0 or v > 255:
                    raise ValueError
            except (TypeError, ValueError):
                raise ElementError(
                    f"invalid {f} of element '{name}': '{fields[f]}'", code="InvalidBonds"
                ) from None
            setattr(e, f, v)
    return e
