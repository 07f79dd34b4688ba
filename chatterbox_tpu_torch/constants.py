"""Global constants of the Chatterbox pipeline (the port's own copy).

Values mirror the reference:
  - src/chatterbox/models/s3tokenizer/s3tokenizer.py:15-19
  - src/chatterbox/models/s3gen/const.py:1
  - src/chatterbox/models/t3/modules/t3_config.py
"""

# S3 tokenizer / voice-encoder input sample rate
S3_SR = 16_000
# speech tokens per second
S3_TOKEN_RATE = 25
# FSQ codebook: 3^8
SPEECH_VOCAB_SIZE = 6561
# start / end-of-speech sentinel tokens appended after the FSQ vocab
SOS = SPEECH_VOCAB_SIZE
EOS = SPEECH_VOCAB_SIZE + 1

# output sample rate of S3Gen / HiFT vocoder
S3GEN_SR = 24_000

# each speech token expands to 2 mel frames (mel runs at 50 fps)
TOKEN_MEL_RATIO = 2

# mel frames -> waveform upsampling of the HiFT vocoder: 8*5*3 convs * 4 iSTFT hop
MEL_TO_WAV_RATIO = 480
