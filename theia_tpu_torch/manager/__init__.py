"""The manager's ingest scoring half (`ingest`)."""
