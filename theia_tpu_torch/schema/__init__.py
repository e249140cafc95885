from .flow_schema import (  # noqa: F401
    Column,
    ColumnKind,
    FLOW_SCHEMA,
    FLOW_COLUMNS,
    STRING_COLUMNS,
    NUMERIC_COLUMNS,
    TADETECTOR_SCHEMA,
    RECOMMENDATIONS_SCHEMA,
    DROPDETECTION_SCHEMA,
    FLOWPATTERNS_SCHEMA,
    SPATIALNOISE_SCHEMA,
    DETSTATE_SCHEMA,
    METRICS_SCHEMA,
    METRICS_TABLE,
    METRICS_VALUE_SCALE,
)
from .columnar import (  # noqa: F401
    ColumnarBatch,
    DictionaryMapper,
    StringDictionary,
)
