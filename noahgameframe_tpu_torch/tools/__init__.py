"""Codegen tooling: the NFFileProcess-equivalent config pipeline.

A copy of ``noahgameframe_tpu/tools/__init__.py``, which imports no jax: the port
keeps its own, since it imports nothing of the JAX package.
"""

from .codegen import (  # noqa: F401
    CodegenPipeline,
    emit_instance_xml,
    emit_logic_class_xml,
    emit_name_constants,
    emit_name_constants_cs,
    emit_name_constants_java,
    load_class_csv,
    load_class_xlsx,
)
from .xlsx import read_xlsx_sheets  # noqa: F401
