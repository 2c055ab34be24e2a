"""N-gram language models: the port's copies of mogasr/lm/{ngram,arpa}.py."""
