"""Data ingestion (reference readers module): batch readers (list, CSV,
JSONL, Parquet, Avro), temporal aggregation, conditional and joined
readers, and the streaming micro-batch readers with their tileplane bulk
scoring (`score_stream`)."""
from .avro import AvroReader, read_avro_file, write_avro_file
from .readers import (
    AggregateReader, ConditionalReader, CSVReader, DataReaders,
    JSONLinesReader, JoinedAggregateReader, JoinedReader, KEY_COLUMN,
    ListReader, ParquetReader, Reader, TimeBasedFilter, TimeColumn,
)
from .streaming import (
    AvroStreamingReader, CSVStreamingReader, FileStreamingReader,
    IterStreamingReader, ListStreamingReader, StreamingReader, score_stream,
)

__all__ = [
    "AggregateReader", "AvroReader", "AvroStreamingReader",
    "ConditionalReader", "CSVReader", "CSVStreamingReader", "DataReaders",
    "FileStreamingReader", "IterStreamingReader", "JSONLinesReader",
    "JoinedAggregateReader", "JoinedReader", "KEY_COLUMN", "ListReader",
    "ListStreamingReader", "ParquetReader", "Reader", "StreamingReader",
    "TimeBasedFilter", "TimeColumn", "read_avro_file", "score_stream",
    "write_avro_file",
]
