"""SCP readers, standard form and padding."""
