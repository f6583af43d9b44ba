"""The port's host C++ libraries: NJAD dither and the FLAC encoder
(``native.loader.load``), and the .dsf reader's de-interleave and bit
reversal (``native.loader.load_reader``), each built with g++ at first
use, never at import."""
