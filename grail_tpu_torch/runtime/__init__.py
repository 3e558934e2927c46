"""Runtime: streaming sessions and the pool server (stream.py), the native
host library (native.py), WAV files (wav.py) and playback sinks
(playback.py)."""
