"""Field output: .vti ImageData files and their time series."""
