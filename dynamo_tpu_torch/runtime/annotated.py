"""Annotated stream envelope — the wire shape of every response stream.

Re-design of the reference's ``Annotated<T>``
(lib/runtime/src/protocols/annotated.rs): each element of a response stream
is either data, an SSE-style event/comment, an error, or the end-of-stream
sentinel. This envelope is what crosses process/node boundaries and what the
SSE layer maps 1:1 onto the OpenAI wire format.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Generic, Optional, TypeVar

T = TypeVar("T")


@dataclass
class Annotated(Generic[T]):
    data: Optional[T] = None
    event: Optional[str] = None
    comment: Optional[list[str]] = None
    error: Optional[str] = None
    id: Optional[str] = None

    @staticmethod
    def from_data(data: T) -> "Annotated[T]":
        return Annotated(data=data)

    @staticmethod
    def from_error(error: str) -> "Annotated[T]":
        return Annotated(event="error", error=error)

    @staticmethod
    def from_annotation(name: str, value: Any) -> "Annotated[T]":
        import json

        return Annotated(event=name, comment=[json.dumps(value)])

    @staticmethod
    def sentinel() -> "Annotated[T]":
        return Annotated(event="sentinel")

    def is_sentinel(self) -> bool:
        return self.event == "sentinel"

    def is_error(self) -> bool:
        return self.error is not None or self.event == "error"

    def to_dict(self, data_to_dict=None) -> dict:
        d: dict[str, Any] = {}
        if self.data is not None:
            d["data"] = data_to_dict(self.data) if data_to_dict else self.data
        if self.event is not None:
            d["event"] = self.event
        if self.comment:
            d["comment"] = self.comment
        if self.error is not None:
            d["error"] = self.error
        if self.id is not None:
            d["id"] = self.id
        return d

    @staticmethod
    def from_dict(d: dict, data_from_dict=None) -> "Annotated[Any]":
        data = d.get("data")
        if data is not None and data_from_dict:
            data = data_from_dict(data)
        return Annotated(
            data=data,
            event=d.get("event"),
            comment=d.get("comment"),
            error=d.get("error"),
            id=d.get("id"),
        )
