"""The port's host C++ library: NJAD dither and the FLAC encoder, built
with g++ at first use (``native.loader.load``), never at import."""
