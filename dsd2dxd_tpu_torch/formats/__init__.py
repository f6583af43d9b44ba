"""Host-side DSD format handling: containers, raw streams, metadata."""
