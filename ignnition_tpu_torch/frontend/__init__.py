"""Model-description front end: schema validation, parsing and the IR."""

from . import ir
from .parser import load_description, parse_model_description, parse_model_file
from .schema import ModelDescriptionError, validate_structure

__all__ = [
    "ir",
    "load_description",
    "parse_model_description",
    "parse_model_file",
    "ModelDescriptionError",
    "validate_structure",
]
