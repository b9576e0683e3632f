"""The LLM model stack of the port: layers, GQA attention and the
decoder-only LM (dense-GQA subset), with the registry the launchers use."""
