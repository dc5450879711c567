"""Data ingestion (reference readers module): batch readers (list, CSV,
JSONL, Parquet, Avro), temporal aggregation, conditional and joined
readers. The streaming micro-batch readers are not ported yet."""
from .avro import AvroReader, read_avro_file, write_avro_file
from .readers import (
    AggregateReader, ConditionalReader, CSVReader, DataReaders,
    JSONLinesReader, JoinedAggregateReader, JoinedReader, KEY_COLUMN,
    ListReader, ParquetReader, Reader, TimeBasedFilter, TimeColumn,
)

__all__ = [
    "AggregateReader", "AvroReader", "ConditionalReader", "CSVReader",
    "DataReaders", "JSONLinesReader", "JoinedAggregateReader",
    "JoinedReader", "KEY_COLUMN", "ListReader", "ParquetReader", "Reader",
    "TimeBasedFilter", "TimeColumn", "read_avro_file", "write_avro_file",
]
