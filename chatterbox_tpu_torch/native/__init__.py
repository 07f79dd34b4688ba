from .loader import NativeBPE, get_lib, native_available, sinf, wav_decode, wav_encode_pcm16

__all__ = ["get_lib", "native_available", "NativeBPE", "wav_decode", "wav_encode_pcm16", "sinf"]
