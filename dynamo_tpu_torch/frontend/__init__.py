"""OpenAI frontend service (ref: components/src/dynamo/frontend)."""

from .service import Frontend

__all__ = ["Frontend"]
