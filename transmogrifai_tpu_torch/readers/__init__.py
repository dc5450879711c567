"""Data ingestion: `ListReader` and `CSVReader` (readers.py)."""
from .readers import CSVReader, KEY_COLUMN, ListReader, Reader

__all__ = ["CSVReader", "KEY_COLUMN", "ListReader", "Reader"]
