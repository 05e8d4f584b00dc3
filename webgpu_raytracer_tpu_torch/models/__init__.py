"""Host-side scene models: the binding to the shared C++ scene compiler."""
