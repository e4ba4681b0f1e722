"""Plain references of the configurations' models, one package each."""
