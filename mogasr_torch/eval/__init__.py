"""WER scoring: the port's copy of mogasr/eval/wer.py."""
