"""Flow schema and columnar encoding (copies of theia_tpu/schema)."""

from .flow_schema import FLOW_SCHEMA  # noqa: F401
from .columnar import (  # noqa: F401
    ColumnarBatch,
    DictionaryMapper,
    StringDictionary,
)
