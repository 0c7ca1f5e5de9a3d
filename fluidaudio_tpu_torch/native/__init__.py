"""Host-side native code of the port, built with the host C++ compiler at first use."""
