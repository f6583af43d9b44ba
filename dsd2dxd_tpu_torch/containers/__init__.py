"""PCM container writers: WAV, AIFF, AIFC (raw output goes to stdout)."""
