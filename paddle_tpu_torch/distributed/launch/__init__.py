"""The launcher's pieces: ``master`` (the HTTP KV store).  Import it
explicitly; this package imports nothing on its own."""
